"""filter_ms_per_picture.encode (ms): self time of the spans around
ops/deblock.py:deblock_picture and IntraEncoder._sao_and_rewrite (the SAO,
ALF and CC-ALF searches, their filters and the slice's final write), per
picture."""


def read(run):
    parts = [run.span_self_s.get(k) for k in ("deblock", "sao_alf")]
    if all(p is None for p in parts) or run.pictures == 0:
        return None
    return 1e3 * sum(p or 0.0 for p in parts) / run.pictures
