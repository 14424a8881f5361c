from .posteriors import PosteriorWriter  # noqa: F401
