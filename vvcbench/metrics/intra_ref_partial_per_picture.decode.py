"""intra_ref_partial_per_picture.decode (fills): the program's
`intra.ref_partial` counter (each intra reference-sample fill with some
units available and some not, so that it pads: decoder/dec_cu.py:
_fill_ref_lengths), per picture of the traced window (progtrace.py).  A
program without the counter reads nothing."""

from vvcbench import progtrace


def read(run):
    return progtrace.count_per_picture(run, "intra.ref_partial")
