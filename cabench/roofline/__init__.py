"""The least time an H100 needs for the ensemble path's work, from frozen
counts: the yardstick of ``fhp_step_roofline``.

Operations: the machine instructions of one fhp2 word-step (32 nodes, one
step: streaming taps, chirality hash, collision circuit, 16-bit Bernoulli
comparator, force) and of one word's moment terms, per pipe, as
``repro_torch/kernels/fhp_step/opcount.py`` counted them from the
kernel's own ``word_step`` compiled for sm_90a (``counts(pq)`` at
p_force 0.03, pq = 1966), once, and written here.  They are never read
again from what the program compiles, so a change to the kernel moves
its time and not its yardstick (``COUNTED`` says where they come from).

Work of a call: lanes x H x Wd x steps owned word-steps (an apron's
repeated word-steps are not counted: the step does not need them) and
lanes x H x Wd x records moment words.  Bytes of a call: its state read
once and written once, and its moments written once.

Peaks (one H100 SXM): per SM and clock, 64 integer-ALU, 64 IMAD, 16
population-count lanes and 128 issued thread-instructions (CUDA C++
Programming Guide, compute capability 9.0 throughput table), at the SM
count and maximum SM clock the card reports; HBM 3.35e12 B/s.
"""
from __future__ import annotations

from typing import Dict, Tuple

# Instructions per owned word-step (``step``) and per moment word of one
# recorded step (``terms``), by pipe; ``other`` counts against issue only.
STEP: Dict[str, float] = {"alu": 251.5, "fma": 33.0, "popc": 0.0,
                          "other": 18.0}
TERMS: Dict[str, float] = {"alu": 5.0, "fma": 3.0, "popc": 8.0,
                           "other": 0.0}
COUNTED_RULES = ("fhp2",)
COUNTED = ("opcount.counts(1966) at commit 37cfdbae on the chip machine "
           "(CUDA 12.8, torch 2.11.0+cu128; NVIDIA H100 80GB HBM3, 700 W, "
           "clocks.max.sm 1980 MHz, 132 SMs)")

SMS = 132
MAX_SM_CLOCK_HZ = 1.98e9
LANES_PER_SM_CLOCK = {"alu": 64, "fma": 64, "popc": 16, "issue": 128}
HBM_BYTES_PER_S = 3.35e12
WORD_BYTES = 4


def ops_seconds(word_steps: float, moment_words: float) -> Tuple[float, str]:
    """Least seconds to issue the instructions of ``word_steps``
    word-steps and ``moment_words`` moment words, and the pipe that sets
    it (the largest of each pipe over its rate and all over issue)."""
    need = {k: word_steps * STEP[k] + moment_words * TERMS[k] for k in STEP}
    need["issue"] = sum(need.values())
    secs = {k: need.get(k, 0.0) / (n * SMS * MAX_SM_CLOCK_HZ)
            for k, n in LANES_PER_SM_CLOCK.items()}
    pipe = max(secs, key=secs.get)
    return secs[pipe], pipe


def call_bound(lanes: int, planes: int, h: int, wd: int, steps: int,
               records: int, n_moments: int) -> Tuple[float, str]:
    """Least seconds of one call of ``steps`` steps on ``lanes`` lanes of
    ``planes`` x ``h`` x ``wd`` words recording ``records`` moment rows of
    ``n_moments``, and what bounds it (a pipe, or ``bytes``)."""
    words = lanes * h * wd
    ops_s, pipe = ops_seconds(words * steps, words * records)
    n_bytes = WORD_BYTES * (2 * words * planes + lanes * records * n_moments)
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return (ops_s, pipe) if ops_s >= bytes_s else (bytes_s, "bytes")
