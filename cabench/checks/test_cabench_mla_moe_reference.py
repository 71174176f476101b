"""The plain DeepSeek-V3 reference that decides the DeepSeek-V3 cell's
``correct``, in the repo's own test run (``python -m pytest`` from the
root): the comparisons of ``check_lm_mla_moe.py`` with the program's
plain CPU ``forward``, and with its prefill and decode through the cache,
at the smoke twin's widths over several seeds and expert shares.  The
benchmark's own checks run the same file under ``-o
python_files='check_*.py'``."""
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent.parent), str(HERE)]

from check_lm_mla_moe import (  # noqa: E402,F401
    test_drawn_weights_depend_on_the_seed_alone,
    test_other_widths_or_parts_are_refused,
    test_recorder_holds_at_most_four_buffers,
    test_reference_is_the_programs_forward,
    test_reference_is_the_programs_prefill_and_decode,
    test_reference_yarn_is_the_programs)
