"""BitstreamExtractorApp equivalent (layer-based subset) — extract one
layer from a multi-layer stream by nuh_layer_id, dropping the VPS and
rewriting layer ids to 0 (BitstreamExtractorApp.cpp OLS extraction path).

Usage:  python -m vtm_tpu_torch.apps.bitstream_extract -b in.bit -o out.bit -l 1
"""

from __future__ import annotations

import argparse
import sys

from vtm_tpu_torch.bitstream import reader as nalio
from vtm_tpu_torch.bitstream.writer import make_nal


def extract_layer(data: bytes, layer_id: int) -> bytes:
    out = bytearray()
    for ebsp in nalio.split_annexb(data):
        nal = nalio.parse_nal(ebsp)
        if nal.nal_unit_type == nalio.NAL_VPS:
            continue  # single-layer output carries no VPS
        if nal.layer_id != layer_id:
            continue
        out += make_nal(nal.nal_unit_type, nal.rbsp, nal.temporal_id, 0)
    return bytes(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vtm_tpu_torch-bitstream-extract")
    ap.add_argument("-b", "--bitstream", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-l", "--layer", type=int, default=0)
    args = ap.parse_args(argv)
    data = open(args.bitstream, "rb").read()
    out = extract_layer(data, args.layer)
    open(args.output, "wb").write(out)
    print(f"extracted layer {args.layer}: {len(out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
