"""Top-level decoder of the port: NAL dispatch, picture lifecycle, hashes.

Forks of vtm_tpu/decoder/declib.py's Decoder and Picture (DecLib.cpp
decode():2632).  Parameter sets, SEI, reference lists and hash checks are
the reference's; what differs:

* the device is explicit: Decoder(device="cuda" | "cpu"), no probe and no
  placement switch;
* slices decode through the port's decompress_slice, and each picture's
  in-loop filter chain runs on that device;
* the chain's packed output stays a device tensor until the picture's first
  host use (`Picture.planes`), fetched with `.cpu().numpy()`; hash checks
  wait for it and drain in decode order;
* `device_planes` of a reference picture are slices of that tensor, for the
  MC of later slices.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vtm_tpu.bitstream import reader as nalio
from vtm_tpu.common.types import ChromaFormat
from vtm_tpu.decoder import declib as _ref
from vtm_tpu.decoder import vlc
from vtm_tpu_torch.decoder import filters
from vtm_tpu_torch.decoder.dec_slice import decompress_slice
from vtm_tpu_torch.device import resolve_device

HashResult = _ref.HashResult


def split_packed(packed: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Views of the chain's packed [Y, Cb, Cr] output as planes of `shapes`."""
    out, pos = [], 0
    for shape in shapes:
        n = shape[0] * shape[1]
        out.append(packed[pos:pos + n].view(shape))
        pos += n
    return out


class Picture(_ref.Picture):
    """Decoded picture whose filter-chain output (`_pending_packed`) is a
    torch tensor on the decoder's device until first host use."""

    @property
    def planes(self) -> list[np.ndarray]:
        if self._pending_packed is not None:
            self._materialize()
        return self._planes

    @planes.setter
    def planes(self, v) -> None:
        self._planes = v
        self._pending_packed = None
        # planes set from outside are not this picture's decode: its queued
        # hash check must not run on them
        dec = self._decoder
        if dec is not None:
            self._decoder = None
            dec._hash_queue.remove(self)

    def _fetch_only(self) -> None:
        packed = self._pending_packed
        if packed is None:
            return
        self._pending_packed = None
        pl = self._planes
        for dst, src in zip(pl, split_packed(packed.cpu(), [p.shape for p in pl])):
            dst[:] = src.numpy().astype(dst.dtype)


class Decoder(_ref.Decoder):
    """Feed NAL units (or whole Annex-B streams) and collect the output
    pictures; the sample path runs on `device`."""

    def __init__(self, device: str | torch.device = "cuda", strict: bool = True):
        self.device = resolve_device(device)
        super().__init__(strict=strict)

    def decode_stream(self, data: bytes) -> list[Picture]:
        for ebsp in nalio.split_annexb(data):
            if self.strict:
                self.decode_nal(nalio.parse_nal(ebsp))
                continue
            try:
                self.decode_nal(nalio.parse_nal(ebsp))
            except NotImplementedError:
                raise  # a tool the port lacks is not a damaged stream
            except Exception as e:  # noqa: BLE001 — resilience path
                self.error_count += 1
                print(f"warning: NAL decode error skipped: {e}", file=sys.stderr)
        self.finish_picture()
        self.flush()
        return self.output

    def _decode_slice(self, nal: nalio.NalUnit) -> None:
        first_flag = nal.rbsp[0] >> 7  # picture_header_in_slice_header_flag
        if first_flag:
            self.finish_picture()
        sh, ph, r = vlc.parse_slice_header(
            nal.rbsp, nal.nal_unit_type, nal.temporal_id, self.psm,
            None if first_flag else self.ph, self.prev_tid0_poc,
        )
        self.ph = ph
        pps = self.psm.pps[ph.pps_id]
        sps = self.psm.sps[pps.sps_id]
        if self.cur_pic is None or self.cur_pic.poc != sh.poc:
            self.finish_picture()
            fmt = sps.chroma_format
            shapes = [(pps.pic_height, pps.pic_width)]
            if fmt != ChromaFormat.YUV400:
                shapes += [(pps.pic_height >> fmt.scale_y, pps.pic_width >> fmt.scale_x)] * 2
            self.cur_pic = Picture(
                poc=sh.poc,
                planes=[np.zeros(s, dtype=np.int32) for s in shapes],
                sps_id=sps.sps_id,
                pps_id=pps.pps_id,
                is_irap=nal.nal_unit_type in nalio.IRAP_NAL_TYPES,
            )
            if self.pending_hash_sei is not None:
                self.cur_pic.hash_sei = self.pending_hash_sei
                self.pending_hash_sei = None
        self.cur_pic.slices.append(sh)
        if nal.temporal_id == 0 and nal.nal_unit_type not in (
            nalio.NAL_RASL, nalio.NAL_RADL
        ):
            self.prev_tid0_poc = sh.poc
        self._construct_ref_lists(sh, sps)
        decompress_slice(self, sps, pps, ph, sh, r)

    def finish_picture(self) -> None:
        if self.cur_pic is None:
            return
        pic = self.cur_pic
        self.cur_pic = None
        # LMCS inverse -> deblock -> SAO -> ALF/CC-ALF on the device
        filters.apply_loop_filters(self, pic)
        # persist the 4x4 motion field for TMVP from later pictures
        if hasattr(pic, "dcs") and hasattr(pic.dcs, "mf_inter"):
            d = pic.dcs
            pic.motion = {
                "inter": d.mf_inter, "ibc": d.mf_ibc, "interdir": d.mf_interdir,
                "mv": d.mf_mv, "refidx": d.mf_refidx, "slice": d.mf_slice,
            }
        pic._seq = self._decode_seq
        self._decode_seq += 1
        if pic.hash_sei is not None:
            if pic._pending_packed is not None:
                # checked at first host use of the planes, in decode order
                pic._decoder = self
                self._hash_queue.append(pic)
            else:
                self._hash_one(pic)
        if pic.is_reference:
            packed = pic._pending_packed
            if packed is not None:
                pic.device_planes = split_packed(
                    packed, [p.shape for p in pic._planes])
            else:
                pic.device_planes = [torch.from_numpy(p).to(self.device)
                                     for p in pic._planes]
        self.dpb.append(pic)
        self.output.append(pic)
