from .bridge import harvest_wer, run_decode, write_decoding_conf  # noqa: F401
