"""The control and the planted faults that the reference check must catch.

Each is a context manager that patches the program for its length; none
is used by a benchmark run.  `run.py --plant NAME` runs a cell with one in
place (the chip runs that read the control), and the harness's tests run
each on the CPU.

- control `alf_off`: the in-loop chain with its ALF and CC-ALF stages left
  out, the approximate decode a faster decoder might be tempted by: it
  breaks the configuration's guarantee of output bit-exact to VTM 9.3;
- fault `chain_unchanged`: the chain returns its input planes unchanged
  (a step that returns its state unchanged);
- fault `half_pictures`: every second picture is left out of the
  decoder's output (half of the batch left out);
- fault `altered_sample`: one sample of each stream's first output
  picture is altered where the decoder hands it out.
"""

from __future__ import annotations

import inspect
from contextlib import contextmanager

from vvcbench.spans import wrap

ALF_FLAGS = slice(10, 15)  # ALF Y, Cb, Cr, CC-ALF Cb, Cr among the 15 stage flags


def _chain_wrapper(edit):
    """chain_body wrapped so that edit(bound arguments, original) runs it."""
    def make(orig):
        sig = inspect.signature(orig)

        def chain_body(*args, **kw):
            return edit(sig.bind(*args, **kw), orig)
        return chain_body
    return make


def _alf_off(b, orig):
    fl = list(b.arguments["fl"])
    fl[ALF_FLAGS] = [False] * 5
    b.arguments["fl"] = tuple(fl)
    return orig(*b.args, **b.kwargs)


def _unchanged(b, orig):
    import torch

    a = b.arguments
    return torch.cat([a["y"].reshape(-1), a["cb"].reshape(-1), a["cr"].reshape(-1)])


def _drop_every_second(orig):
    def finish_picture(dec):
        n = len(dec.output)
        orig(dec)
        if len(dec.output) > n and len(dec.output) % 2 == 0:
            dec.output.pop()
    return finish_picture


def _alter_first(orig):
    def flush(dec):
        orig(dec)
        if dec.output:
            dec.output[0].planes[0][0, 0] ^= 1
    return flush


def _patches(name: str):
    from vtm_tpu_torch.decoder.declib import Decoder
    from vtm_tpu_torch.ops import filter_chain as FC

    if name == "alf_off":
        return [(FC, "chain_body", _chain_wrapper(_alf_off))]
    if name == "chain_unchanged":
        return [(FC, "chain_body", _chain_wrapper(_unchanged))]
    if name == "half_pictures":
        return [(Decoder, "finish_picture", _drop_every_second)]
    if name == "altered_sample":
        return [(Decoder, "flush", _alter_first)]
    raise ValueError(f"unknown plant {name!r}: one of {PLANTS}")


PLANTS = ("alf_off", "chain_unchanged", "half_pictures", "altered_sample")


@contextmanager
def planted(name: str | None):
    if name is None:
        yield
        return
    undo = [wrap(owner, attr, make) for owner, attr, make in _patches(name)]
    try:
        yield
    finally:
        for u in reversed(undo):
            u()
