"""parcat — bit-exact concatenation of independently encoded segments.

Equivalent of App/Parcat/parcat.cpp (the reference's GOP-parallel scaling
mechanism, readme: App/Parcat/readme.md): segments after the first drop
their duplicated parameter sets / AUD / PH NALs (up to the first IDR) and
their IDR access units entirely (the IDR re-codes the previous segment's
last picture), and the POC LSBs of the remaining slices are rewritten for
continuous numbering (parcat.cpp filter_segment:206).

Usage:  python -m vtm_tpu_torch.apps.parcat seg1.bit seg2.bit ... out.bit
"""

from __future__ import annotations

import sys

from vtm_tpu_torch.bitstream import reader as nalio
from vtm_tpu_torch.bitstream.reader import BitReader
from vtm_tpu_torch.bitstream.writer import make_nal
from vtm_tpu_torch.decoder import vlc

_SLICE_TYPES = nalio.SLICE_NAL_TYPES
_IDR_TYPES = frozenset([nalio.NAL_IDR_W_RADL, nalio.NAL_IDR_N_LP])


def _poc_lsb_bit_offset(rbsp: bytes, in_slice_header: bool) -> int:
    """Bit offset of ph_pic_order_cnt_lsb inside a PH (or PH-in-SH) RBSP."""
    r = BitReader(rbsp)
    if in_slice_header:
        flag = r.flag()
        assert flag, "slice without embedded picture header"
    gdr_or_irap = r.flag()
    if gdr_or_irap:
        r.flag()  # gdr_pic_flag
    inter_allowed = r.flag()
    if inter_allowed:
        r.flag()  # intra_slice_allowed
    r.flag()  # non_reference_picture
    r.ue()  # pps id
    return r.pos


def _rewrite_poc(rbsp: bytes, off: int, bits: int, new_lsb: int) -> bytes:
    data = bytearray(rbsp)
    for i in range(bits):
        bit = (new_lsb >> (bits - 1 - i)) & 1
        byte_i, bit_i = (off + i) >> 3, 7 - ((off + i) & 7)
        if bit:
            data[byte_i] |= 1 << bit_i
        else:
            data[byte_i] &= ~(1 << bit_i)
    return bytes(data)


def _count_pictures(nals) -> int:
    n = 0
    for nal in nals:
        if nal.nal_unit_type in _SLICE_TYPES:
            r = BitReader(nal.rbsp)
            if r.flag():  # picture_header_in_slice_header → new picture
                n += 1
        elif nal.nal_unit_type == nalio.NAL_PH:
            n += 1
    return n


def parcat(paths: list[str], overlap: bool = False) -> bytes:
    """Stitch segments.

    overlap=False (default): segments are split at IRAP boundaries (each
    segment starts with its own IDR of a NEW frame — the GOP/segment
    parallel encode this framework uses for multi-host scaling). Duplicate
    parameter sets are dropped and every slice POC (including IDRs) is
    shifted for continuous numbering; output is bit-identical to the
    sequential intra-period encode.

    overlap=True: reference parcat semantics (JVET-B0036): segment k>1
    re-codes the previous segment's last frame as an IDR that is dropped
    here, and only non-IDR POCs are rewritten."""
    out = bytearray()
    poc_base = 0
    last_idr_poc = 0
    sps = None
    for idx, path in enumerate(paths, start=1):
        data = open(path, "rb").read()
        nals = [nalio.parse_nal(e) for e in nalio.split_annexb(data)]
        if sps is None:
            for nal in nals:
                if nal.nal_unit_type == nalio.NAL_SPS:
                    sps = vlc.parse_sps(nal.rbsp)
                    break
        bits_for_poc = sps.bits_for_poc if sps else 8
        idr_found = False
        drop_sei_of_idr = False
        for nal in nals:
            t = nal.nal_unit_type
            is_slice = t in _SLICE_TYPES
            is_idr = t in _IDR_TYPES
            if idx > 1:
                if overlap and is_idr:
                    idr_found = True
                    drop_sei_of_idr = True
                    continue  # drop the duplicated IDR AU
                if overlap and drop_sei_of_idr:
                    if t == nalio.NAL_SUFFIX_SEI:
                        continue  # the dropped IDR's hash SEI
                    if is_slice:
                        drop_sei_of_idr = False
                if (overlap and not idr_found) or (not overlap and not idr_found and not is_slice and t != nalio.NAL_PH):
                    # the APS go with the parameter sets, as in the
                    # reference's parcat: a later segment's ALF APS is
                    # dropped, and its slices then use the first segment's
                    # filters (kept for byte parity; encode ALF-free
                    # segments)
                    if t in (
                        nalio.NAL_DCI, nalio.NAL_VPS, nalio.NAL_SPS, nalio.NAL_PPS,
                        nalio.NAL_PREFIX_APS, nalio.NAL_SUFFIX_APS,
                        nalio.NAL_AUD,
                    ) or (overlap and t in (nalio.NAL_PH, nalio.NAL_PREFIX_SEI,
                                            nalio.NAL_SUFFIX_SEI)):
                        if t == nalio.NAL_PH:
                            idr_found = True  # PH of the dropped IDR
                        continue
                if is_slice:
                    idr_found = True
            rbsp = nal.rbsp
            rewrite = idx > 1 and (is_slice or t == nalio.NAL_PH) and (
                not is_idr or not overlap)
            if rewrite:
                in_sh = is_slice
                if is_slice:
                    r = BitReader(rbsp)
                    if not r.flag():
                        # PH carried in a separate PH NAL; POC fixed there
                        out += make_nal(t, rbsp, nal.temporal_id, nal.layer_id)
                        continue
                off = _poc_lsb_bit_offset(rbsp, in_sh)
                r = BitReader(rbsp)
                r.pos = off
                old_lsb = r.u(bits_for_poc)
                new_poc = old_lsb + poc_base
                new_lsb = (new_poc - last_idr_poc) & ((1 << bits_for_poc) - 1)
                rbsp = _rewrite_poc(rbsp, off, bits_for_poc, new_lsb)
            out += make_nal(t, rbsp, nal.temporal_id, nal.layer_id)
        # overlap mode: segment k re-codes the previous segment's last
        # frame as its (dropped) IDR → base advances by count-1
        poc_base += _count_pictures(nals) - (1 if overlap else 0)
    return bytes(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    overlap = "--overlap" in argv
    argv = [a for a in argv if a != "--overlap"]
    if len(argv) < 2:
        print("usage: parcat [--overlap] <seg1> [<seg2> ...] <outfile>",
              file=sys.stderr)
        return 2
    out = parcat(argv[:-1], overlap=overlap)
    open(argv[-1], "wb").write(out)
    print(f"wrote {len(out)} bytes from {len(argv) - 1} segments")
    return 0


if __name__ == "__main__":
    sys.exit(main())
