"""Tolerant decode through vtm_tpu_torch: the port's twins of
tests/test_robustness.py, each held to vtm_tpu's decoder on the same bytes.

With strict=False both decoders count any exception of a NAL, skip the NAL
and decode on (DecLib error resilience), and conceal a lost reference
picture from the nearest decoded one (DecLib::xCreateLostPicture).  The
port decodes on the CPU; pictures, error and concealment counts and hash
results must equal the reference's.
"""

import os

import numpy as np
import pytest

from vtm_tpu.decoder.declib import Decoder as RefDecoder
from vtm_tpu_torch.bitstream import reader as nalio
from vtm_tpu_torch.bitstream import writer as nalw
from vtm_tpu_torch.decoder.declib import Decoder

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "testdata")
START = b"\x00\x00\x00\x01"


def _nal_units(name):
    with open(os.path.join(TESTDATA, f"{name}.bit"), "rb") as f:
        return nalio.split_annexb(f.read())


def _decode_both(stream: bytes):
    """Both decoders, tolerant, on the same bytes; their results equal."""
    ref = RefDecoder(strict=False)
    ref_pics = ref.decode_stream(stream)
    dec = Decoder(device="cpu", strict=False)
    pics = dec.decode_stream(stream)
    assert [p.poc for p in pics] == [p.poc for p in ref_pics]
    for p, r in zip(pics, ref_pics):
        for a, b in zip(p.planes, r.planes):
            np.testing.assert_array_equal(a, b)
    assert (dec.error_count, dec.concealed_count) == (ref.error_count,
                                                      ref.concealed_count)
    assert [(h.poc, h.ok, h.computed) for h in dec.hash_results] == \
        [(h.poc, h.ok, h.computed) for h in ref.hash_results]
    return dec, pics


def test_lost_reference_concealment():
    """One leading reference picture's slice NAL dropped from an RA stream:
    the port conceals it as the reference does and finishes the stream."""
    nals = _nal_units("ra_full_small208_qp32")
    slice_idx = [i for i, e in enumerate(nals)
                 if nalio.parse_nal(e).nal_unit_type in nalio.SLICE_NAL_TYPES]
    assert len(slice_idx) >= 3
    stream = b"".join(START + e for i, e in enumerate(nals) if i != slice_idx[1])
    dec, pics = _decode_both(stream)
    assert dec.concealed_count >= 1
    assert len(pics) >= 1


def test_tolerant_mode_skips_garbage_nal():
    nals = _nal_units("ai_full_tiny64_qp32")
    rng = np.random.default_rng(0)
    garbage = bytes([0x01, 0x00]) + rng.integers(0, 255, 64).astype(np.uint8).tobytes()
    stream = START + nals[0] + START + garbage + b"".join(START + e for e in nals[1:])
    dec, pics = _decode_both(stream)
    assert dec.error_count >= 1
    assert len(pics) == len(Decoder(device="cpu").decode_stream(
        b"".join(START + e for e in nals)))
    assert all(hr.ok for hr in dec.hash_results)


def _with_sps_extension(ebsp: bytes) -> bytes:
    """The SPS NAL with sps_extension_present_flag (the bit before the
    RBSP stop bit) set, which both packages' parsers refuse with
    NotImplementedError("SPS extensions not supported")."""
    rbsp = bytearray(nalio.parse_nal(ebsp).rbsp)
    i = max(k for k, b in enumerate(rbsp) if b)
    stop = (rbsp[i] & -rbsp[i]).bit_length() - 1  # the stop bit, 0 = LSB
    if stop == 7:
        rbsp[i - 1] |= 1
    else:
        rbsp[i] |= 1 << (stop + 1)
    return ebsp[:2] + nalw.rbsp_to_ebsp(bytes(rbsp))


def test_tolerant_mode_skips_unsupported_tool():
    """A second SPS that reaches one of the parsers' NotImplementedErrors:
    the strict port raises it; tolerant, both decoders count it, skip it and
    decode every picture hash-exact."""
    nals = _nal_units("ai_full_tiny64_qp32")
    sps = next(i for i, e in enumerate(nals)
               if nalio.parse_nal(e).nal_unit_type == nalio.NAL_SPS)
    bad = _with_sps_extension(nals[sps])
    stream = b"".join(START + e for e in nals[:sps + 1]) + START + bad \
        + b"".join(START + e for e in nals[sps + 1:])
    with pytest.raises(NotImplementedError, match="SPS extensions"):
        Decoder(device="cpu").decode_stream(stream)
    dec, pics = _decode_both(stream)
    assert dec.error_count == 1
    assert len(pics) == 2 and all(hr.ok for hr in dec.hash_results)
