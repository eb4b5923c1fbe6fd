"""intra_mip_blocks_per_picture.decode (blocks): the program's `intra.mip`
counter (each luma block the decoder predicts by MIP,
decoder/dec_cu.py:intra_rec_blk), per picture of the traced window
(progtrace.py).  A program without the counter reads nothing."""

from vvcbench import progtrace


def read(run):
    return progtrace.count_per_picture(run, "intra.mip")
