"""SEIRemovalApp equivalent — strips SEI NAL units from a bitstream.

Usage:  python -m vtm_tpu_torch.apps.sei_removal -b in.bit -o out.bit
            [--keep-suffix] [--keep-prefix]
"""

from __future__ import annotations

import argparse
import sys

from vtm_tpu_torch.bitstream import reader as nalio
from vtm_tpu_torch.bitstream.writer import make_nal


def remove_sei(data: bytes, drop_prefix: bool = True,
               drop_suffix: bool = True) -> bytes:
    out = bytearray()
    for ebsp in nalio.split_annexb(data):
        nal = nalio.parse_nal(ebsp)
        if nal.nal_unit_type == nalio.NAL_PREFIX_SEI and drop_prefix:
            continue
        if nal.nal_unit_type == nalio.NAL_SUFFIX_SEI and drop_suffix:
            continue
        out += make_nal(nal.nal_unit_type, nal.rbsp, nal.temporal_id, nal.layer_id)
    return bytes(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vtm_tpu_torch-sei-removal")
    ap.add_argument("-b", "--bitstream", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--keep-prefix", action="store_true")
    ap.add_argument("--keep-suffix", action="store_true")
    args = ap.parse_args(argv)
    data = open(args.bitstream, "rb").read()
    out = remove_sei(data, not args.keep_prefix, not args.keep_suffix)
    open(args.output, "wb").write(out)
    print(f"{len(data)} -> {len(out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
