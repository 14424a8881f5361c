"""Raw-waveform feature dumper (the port's copy of tpukaldi's
`tools/save_raw_fea.py`, reference save_raw_fea.py).

Cuts each waveform into windows of `--sig-wlen` ms (200 by default)
centred on the 25 ms / 10 ms label frames (zero-padded at the utterance's
edges) and writes one ark per utterance plus an scp: the input of the
SincNet and CNN raw-waveform recipes.

  python -m tpukaldi_torch.tools.save_raw_fea --wav-lst wav.scp \\
      --out-folder raw_200ms/train [--sig-wlen 200] [--lab-wlen 25]
      [--lab-wshift 10] [--fs 16000]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io import kaldi_io as kio


def window_signal(
    signal: np.ndarray,
    sig_wlen_samp: int,
    lab_wlen_samp: int,
    lab_wshift_samp: int,
) -> np.ndarray:
    """(n_frames, sig_wlen_samp) windows aligned to label frame centres
    (reference save_raw_fea.py:88-108)."""
    frames = []
    beg = 0
    half_win = sig_wlen_samp // 2
    half_idx = half_win - 1
    n = signal.shape[0]
    while beg + lab_wlen_samp < n:
        center = int(beg + lab_wlen_samp / 2) - 1
        lo, hi = center - half_win, center + half_win
        fr = np.zeros(sig_wlen_samp, dtype=np.float64)
        if lo >= 0 and hi <= n:
            fr = signal[lo:hi]
        else:
            if lo < 0:
                fr[half_idx - center + 1:] = signal[0:hi]
            if hi > n:
                fr[0:half_idx + (n - center) + 1] = signal[lo:]
        frames.append(fr)
        beg += lab_wshift_samp
    return np.asarray(frames)


def dump_raw_features(
    wav_lst: str,
    out_folder: str,
    fs: int = 16000,
    sig_wlen_ms: int = 200,
    lab_wlen_ms: int = 25,
    lab_wshift_ms: int = 10,
    scp_name: str = "feats_raw.scp",
) -> str:
    sig_wlen = int(fs * sig_wlen_ms / 1000)
    lab_wlen = int(fs * lab_wlen_ms / 1000)
    lab_wshift = int(fs * lab_wshift_ms / 1000)
    os.makedirs(out_folder, exist_ok=True)
    scp_path = os.path.join(out_folder, scp_name)
    with open(scp_path, "w") as scp:
        with open(wav_lst) as f:
            entries = [line.split() for line in f if line.strip()]
        for sig_id, sig_path in entries:
            with open(sig_path, "rb") as wf:
                signal = kio.read_vec_flt(wf).astype(np.float64)
            signal = signal / 32768.0
            signal = signal / np.max(np.abs(signal))
            frames = window_signal(signal, sig_wlen, lab_wlen, lab_wshift)
            ark = os.path.join(out_folder, f"{sig_id}.ark")
            with open(ark, "wb") as af:
                kio.write_mat(af, frames.astype(np.float32), key=sig_id)
            scp.write(f"{sig_id} {os.path.abspath(ark)}:{len(sig_id) + 1}\n")
    return scp_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--wav-lst", required=True)
    p.add_argument("--out-folder", required=True)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--sig-wlen", type=int, default=200)
    p.add_argument("--lab-wlen", type=int, default=25)
    p.add_argument("--lab-wshift", type=int, default=10)
    a = p.parse_args(argv)
    scp = dump_raw_features(
        a.wav_lst, a.out_folder, a.fs, a.sig_wlen, a.lab_wlen, a.lab_wshift
    )
    print(scp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
