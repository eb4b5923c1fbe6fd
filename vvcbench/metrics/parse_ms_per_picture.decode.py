"""parse_ms_per_picture.decode (ms): the program's `parse` timer (CABAC and
syntax parsing, each CTU's SyntaxReader.coding_tree_unit), per picture of
the traced window (progtrace.py)."""

from vvcbench import progtrace


def read(run):
    return progtrace.ms_per_picture(run, timers=("parse",))
