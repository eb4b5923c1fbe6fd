"""SEI message parsing.

Ref: DecoderLib/SEIread.cpp xReadSEImessage:136 (0xFF-extended payload
type/size framing), xParseSEIDecodedPictureHash:423, and the payload
parsers below (buffering period :627, picture timing :718, frame-field
info, HDR metadata payloads).  Unknown payload types are kept raw.
"""

from __future__ import annotations

from dataclasses import dataclass

SEI_BUFFERING_PERIOD = 0
SEI_PICTURE_TIMING = 1
SEI_USER_DATA_UNREGISTERED = 5
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144
SEI_AMBIENT_VIEWING_ENV = 148
SEI_FRAME_FIELD_INFO = 168
SEI_DECODED_PICTURE_HASH = 132


@dataclass
class SeiMessage:
    payload_type: int
    payload: bytes


@dataclass
class DecodedPictureHash:
    hash_type: int  # 0=MD5, 1=CRC, 2=checksum
    digest: bytes


def parse_sei_rbsp(rbsp: bytes) -> list[SeiMessage]:
    msgs = []
    i = 0
    n = len(rbsp)
    # stop at rbsp trailing: last byte with stop bit; conservatively stop when
    # fewer than 2 bytes remain (type+size minimum) or only trailing bits left
    while i < n:
        if i == n - 1:  # trailing byte (0x80)
            break
        ptype = 0
        while rbsp[i] == 0xFF:
            ptype += 255
            i += 1
        ptype += rbsp[i]
        i += 1
        psize = 0
        while rbsp[i] == 0xFF:
            psize += 255
            i += 1
        psize += rbsp[i]
        i += 1
        msgs.append(SeiMessage(ptype, rbsp[i : i + psize]))
        i += psize
    return msgs


def parse_decoded_picture_hash(payload: bytes) -> DecodedPictureHash:
    return DecodedPictureHash(payload[0], payload[1:])


def parse_buffering_period(payload: bytes) -> dict:
    """buffering_period() (SEIread.cpp xParseSEIBufferingPeriod:627):
    CPB/DPB delay field lengths + initial removal delays per sublayer."""
    from vtm_tpu_torch.bitstream.reader import BitReader

    r = BitReader(payload)
    bp: dict = {}
    bp["nal_hrd"] = bool(r.flag())
    bp["vcl_hrd"] = bool(r.flag())
    bp["initial_cpb_removal_delay_len"] = r.u(5) + 1
    bp["cpb_removal_delay_len"] = r.u(5) + 1
    bp["dpb_output_delay_len"] = r.u(5) + 1
    bp["alt_cpb_params"] = bool(r.flag())
    bp["du_hrd"] = bool(r.flag())
    if bp["du_hrd"]:
        bp["du_cpb_removal_delay_increment_len"] = r.u(5) + 1
        bp["dpb_output_delay_du_len"] = r.u(5) + 1
        bp["du_cpb_in_pt"] = bool(r.flag())
        bp["du_dpb_in_pt"] = bool(r.flag())
    else:
        bp["du_cpb_in_pt"] = bp["du_dpb_in_pt"] = False
    bp["concatenation"] = bool(r.flag())
    if r.flag():  # additional_concatenation_info_present
        bp["max_initial_removal_delay_for_concat"] = r.u(
            bp["initial_cpb_removal_delay_len"])
    bp["au_cpb_removal_delay_delta"] = r.u(bp["cpb_removal_delay_len"]) + 1
    bp["cpb_removal_delay_deltas_present"] = bool(r.flag())
    bp["num_cpb_removal_delay_deltas"] = 0
    bp["max_sublayers"] = 1
    if bp["cpb_removal_delay_deltas_present"]:
        n = r.ue() + 1
        bp["num_cpb_removal_delay_deltas"] = n
        bp["cpb_removal_delay_deltas"] = [
            r.u(bp["cpb_removal_delay_len"]) for _ in range(n)]
        # VTM 9.3 writes bp_max_sub_layers_minus1 only on this branch
        # (SEIwrite.cpp xWriteSEIBufferingPeriod)
        bp["max_sublayers"] = r.u(3) + 1
    bp["cpb_cnt"] = r.ue() + 1
    sub_init = bool(r.flag())
    bp["sublayer_initial_cpb_removal_delay_present"] = sub_init
    delays = {}
    for i in range(0 if sub_init else bp["max_sublayers"] - 1,
                   bp["max_sublayers"]):
        for which in ("nal", "vcl"):
            if not bp[f"{which}_hrd"]:
                continue
            delays[(i, which)] = [
                (r.u(bp["initial_cpb_removal_delay_len"]),
                 r.u(bp["initial_cpb_removal_delay_len"]))
                for _ in range(bp["cpb_cnt"])]
    bp["initial_removal"] = delays
    if r.flag():  # sublayer_dpb_output_offsets_present
        bp["dpb_output_tid_offset"] = [
            r.ue() for _ in range(bp["max_sublayers"] - 1)] + [0]
    if bp["alt_cpb_params"]:
        bp["use_alt_cpb_params"] = bool(r.flag())
    return bp


def parse_pic_timing(payload: bytes, bp: dict, temporal_id: int) -> dict:
    """picture_timing() (xParseSEIPictureTiming:718) — the common shape
    (no alt-CPB timing, no DU fields in PT)."""
    from vtm_tpu_torch.bitstream.reader import BitReader

    r = BitReader(payload)
    pt: dict = {}
    msl = bp["max_sublayers"]
    pt["au_cpb_removal_delay"] = {msl - 1: r.u(bp["cpb_removal_delay_len"])
                                  + 1}
    if bp["alt_cpb_params"]:
        pt["cpb_alt_timing_info_present"] = bool(r.flag())
        if pt["cpb_alt_timing_info_present"]:
            raise NotImplementedError("alt CPB timing info")
    for i in range(temporal_id, msl - 1):
        if r.flag():  # pt_sub_layer_delays_present
            delta_en = (bool(r.flag())
                        if bp["cpb_removal_delay_deltas_present"] else False)
            if delta_en:
                n = bp["num_cpb_removal_delay_deltas"]
                pt.setdefault("delta_idx", {})[i] = (
                    r.u(max(1, (n - 1).bit_length())) if n > 1 else 0)
            else:
                pt["au_cpb_removal_delay"][i] = (
                    r.u(bp["cpb_removal_delay_len"]) + 1)
    pt["dpb_output_delay"] = r.u(bp["dpb_output_delay_len"])
    return pt


def parse_frame_field_info(payload: bytes) -> dict:
    """frame_field_info() (xParseSEIFrameFieldinfo behavior)."""
    from vtm_tpu_torch.bitstream.reader import BitReader

    r = BitReader(payload)
    out: dict = {"field_pic": bool(r.flag())}
    if out["field_pic"]:
        out["bottom_field"] = bool(r.flag())
        out["pairing_indicated"] = bool(r.flag())
        if out["pairing_indicated"]:
            out["paired_with_next"] = bool(r.flag())
        out["display_fields_from_frame"] = bool(r.flag())
        if out["display_fields_from_frame"]:
            out["top_field_first"] = bool(r.flag())
        out["display_elemental_periods"] = r.u(8)
    else:
        out["display_elemental_periods"] = r.u(8)
    out["source_scan_type"] = r.u(2)
    out["duplicate"] = bool(r.flag())
    return out


def parse_content_light_level(payload: bytes) -> dict:
    from vtm_tpu_torch.bitstream.reader import BitReader

    r = BitReader(payload)
    return {"max_content_light_level": r.u(16),
            "max_pic_average_light_level": r.u(16)}


def parse_mastering_display(payload: bytes) -> dict:
    from vtm_tpu_torch.bitstream.reader import BitReader

    r = BitReader(payload)
    return {"primaries": [(r.u(16), r.u(16)) for _ in range(3)],
            "white_point": (r.u(16), r.u(16)),
            "max_luminance": r.u(32), "min_luminance": r.u(32)}


def parse_ambient_viewing_environment(payload: bytes) -> dict:
    from vtm_tpu_torch.bitstream.reader import BitReader

    r = BitReader(payload)
    return {"illuminance": r.u(32), "light_x": r.u(16), "light_y": r.u(16)}


def parse_user_data_unregistered(payload: bytes) -> dict:
    return {"uuid": payload[:16], "data": payload[16:]}


def parse_known_payload(msg: SeiMessage, bp: dict | None = None,
                        temporal_id: int = 0):
    """Dispatch to the typed parser for a known payload type; None for
    types kept raw (and for picture timing without a buffering period)."""
    t = msg.payload_type
    if t == SEI_DECODED_PICTURE_HASH:
        return parse_decoded_picture_hash(msg.payload)
    if t == SEI_BUFFERING_PERIOD:
        return parse_buffering_period(msg.payload)
    if t == SEI_PICTURE_TIMING:
        return parse_pic_timing(msg.payload, bp, temporal_id) \
            if bp is not None else None
    if t == SEI_FRAME_FIELD_INFO:
        return parse_frame_field_info(msg.payload)
    if t == SEI_CONTENT_LIGHT_LEVEL:
        return parse_content_light_level(msg.payload)
    if t == SEI_MASTERING_DISPLAY:
        return parse_mastering_display(msg.payload)
    if t == SEI_AMBIENT_VIEWING_ENV:
        return parse_ambient_viewing_environment(msg.payload)
    if t == SEI_USER_DATA_UNREGISTERED:
        return parse_user_data_unregistered(msg.payload)
    return None
