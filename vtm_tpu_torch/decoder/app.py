"""Decoder application of the port (DecApp equivalent, DecApp.cpp:76).

Usage:  python -m vtm_tpu_torch.decoder.app -b in.bit -o out.yuv
                 [-d bitdepth] [--opl out.opl] [--device cuda|cpu]

Decodes an Annex-B VVC bitstream on the given torch device (default cuda;
without CUDA it fails rather than run elsewhere), writes the output
pictures in display order, verifies decoded-picture-hash SEIs, and
optionally writes a conformance `.opl` file (POC, resolution, MD5 per
picture — DecApp.cpp:329-333).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vtm_tpu_torch-decoder")
    ap.add_argument("-b", "--bitstream", required=True)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-d", "--output-bit-depth", type=int, default=0,
                    help="0 = native internal bit depth")
    ap.add_argument("--opl", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sample path (cuda or cpu)")
    args = ap.parse_args(argv)

    from vtm_tpu.utils import pic_hash, yuv_io
    from vtm_tpu_torch.decoder.declib import Decoder

    with open(args.bitstream, "rb") as f:
        data = f.read()
    dec = Decoder(device=args.device)
    t0 = time.time()
    pics = dec.decode_stream(data)
    dt = time.time() - t0
    mismatches = 0
    for hr in dec.hash_results:
        status = "OK" if hr.ok else "***ERROR***"
        print(f"POC {hr.poc:5d}  [MD5:{hr.computed.hex()},({status})]")
        mismatches += 0 if hr.ok else 1
    sps = dec.psm.sps[pics[0].sps_id] if pics else None
    bd = sps.bit_depth if sps else 8
    if args.output and pics:
        out_bd = args.output_bit_depth or bd
        h, w = pics[0].planes[0].shape
        fmt = yuv_io.YuvFormat(w, h, sps.chroma_format, out_bd)
        frames = [yuv_io.scale_planes(p.planes, out_bd - bd) for p in pics]
        yuv_io.write_yuv(args.output, frames, fmt)
    if args.opl and pics:
        with open(args.opl, "w") as f:
            for p in pics:
                digest = pic_hash.pic_md5(p.planes, [bd] * len(p.planes))
                h, w = p.planes[0].shape
                f.write(f"{p.poc},{w},{h},{digest.hex()}\n")
    n = len(pics)
    print(f"decoded {n} pictures in {dt:.2f} s ({n / dt:.2f} fps) on "
          f"{dec.device}, {mismatches} hash mismatches")
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
