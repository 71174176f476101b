"""Machine instructions of one word-step of the CUDA kernel, counted from
its compiled code, and the least time an H100 needs to issue them.

``csrc/op_count.cu`` compiles the kernel's own per-word function
(``word_step`` in ``csrc/fhp_step.cuh``: streaming taps, chirality hash,
collision circuit, Bernoulli rounds, force) and the fhp2 moment terms into
probes that are straight-line register code for one ``p_force``.
The same word-step with its random words read from memory
(``word_step_pre``, kernel mode K2) is counted beside it.
``counts`` builds them with ``nvcc -cubin`` for ``sm_90a``, reads their
SASS with ``cuobjdump`` and sorts each instruction onto the pipe that
executes it, less the probes' own indexing, loads and stores (the ``copy``
probe).  The tiled kernel's indexing, shared-memory traffic and barriers
and its apron's repeated word-steps are not counted: the step does not
need them.  ``loop_bodies`` counts the built kernel's own loops instead
(``cuobjdump -sass`` of the library), so the round loop's instructions
per word-step can stand beside the probe's.

``ops_ms`` turns counts into the least time for a number of word-steps:
the largest of each pipe's instructions over its rate and of all of them
over the issue rate.  Rates per SM and clock, from the CUDA C++
Programming Guide's arithmetic throughput table for compute capability
9.0: 64 for the integer ALU (logic, shifts, adds, compares, selects), 64
for 32-bit integer multiply-add (IMAD, on the FMA pipe), 16 for
population count, and 128 thread-instructions issued (4 schedulers, one
warp instruction each).  They are scaled to the card by the H100 SXM's 67
TFLOP/s float32 peak, which is 128 FMA lanes x 2 flops per SM and clock.
Instructions of no listed pipe (the uniform datapath's, for one) count
against the issue rate only.

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a GPU.
"""
from __future__ import annotations

import collections
import re
import subprocess
from typing import Dict, Tuple

from repro_torch.kernels.fhp_step import build

SOURCE = build.CSRC / "op_count.cu"
F32_FLOPS_PER_S = 67e12
SM_CLOCKS_PER_S = F32_FLOPS_PER_S / (128 * 2)        # summed over the SMs
WORDS_PER_ROUND = 2   # word-steps a thread computes per round (fhp_step.cuh)
LANES_PER_SM_CLOCK = {"alu": 64, "fma": 64, "popc": 16, "issue": 128}

PIPES = {
    **dict.fromkeys("LOP3 LOP SHF SHL SHR IADD3 IADD ISETP SEL LEA PRMT MOV "
                    "IABS IMNMX PLOP3 BMSK SGXT".split(), "alu"),
    "IMAD": "fma", "IMUL": "fma",
    "POPC": "popc", "FLO": "popc", "BREV": "popc",
}
# Loads, stores, special registers and control flow: not arithmetic.
NOT_COUNTED = frozenset("LDG STG LDC ULDC LDS STS LD ST S2R S2UR CS2R BRA "
                        "EXIT NOP BAR RET BSSY BSYNC WARPSYNC CALL".split())

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+"          # address
                   r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")  # predicate, op


def parse_sass(text: str) -> Dict[str, collections.Counter]:
    """Opcode counts (the mnemonic before its first ``.``) of each function
    in ``cuobjdump -sass`` output."""
    funcs: Dict[str, collections.Counter] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur[m.group(1).split(".")[0]] += 1
    return funcs


def pipe_counts(ops: collections.Counter) -> Dict[str, int]:
    """Instructions per pipe (``other``: issue rate only) of one probe,
    which must be straight-line register code: one branch, the trap loop
    after ``EXIT``, and no local memory."""
    if ops["BRA"] > 1 or ops["LDL"] or ops["STL"]:
        raise RuntimeError(f"probe is not straight-line register code: "
                           f"{dict(ops)}")
    out = dict.fromkeys(("alu", "fma", "popc", "other"), 0)
    for op, n in ops.items():
        if op not in NOT_COUNTED:
            out[PIPES.get(op, "other")] += n
    return out


def word_step_counts(sass: str) -> Dict[str, Dict[str, float]]:
    """Per-pipe instructions of one fhp2 word-step (``step``, the mean of
    the two row parities), of the same with precomputed random words
    (``pre``) and of one word's moment terms (``terms``), each less the
    ``copy`` probe; ``opcodes``: the even-row probe's opcodes."""
    f = parse_sass(sass)
    base = pipe_counts(f["copy"])

    def mean_of(a, b):
        a, b = pipe_counts(f[a]), pipe_counts(f[b])
        return {k: max(0.0, (a[k] + b[k]) / 2 - base[k]) for k in base}

    terms = pipe_counts(f["terms"])
    return {"step": mean_of("step_even", "step_odd"),
            "pre": mean_of("pre_even", "pre_odd"),
            "terms": {k: max(0, terms[k] - base[k]) for k in base},
            "opcodes": dict(f["step_even"].most_common())}


_ADDR_INSN = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"(0x[0-9a-f]+)")


def loop_bodies(sass: str, name_part: str) -> list:
    """The loops of the first function whose name contains ``name_part``
    in ``cuobjdump -sass`` output: one dict per backward branch, with the
    instructions from its target to the branch by pipe (``pipe_counts``'
    pipes, plus ``shared`` loads and stores and ``barriers``), largest
    first.  A kernel's round loop is the one with two barriers."""
    insns, cur = [], None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            if insns:
                break
            cur = name_part in m.group(1)
            continue
        m = _ADDR_INSN.match(line)
        if m and cur:
            insns.append((int(m.group(1), 16), m.group(2).split(".")[0],
                          m.group(3)))
    loops = []
    for addr, op, rest in insns:
        t = _TARGET.search(rest) if op == "BRA" else None
        if t is None or int(t.group(1), 16) >= addr:
            continue
        lo = int(t.group(1), 16)
        ops = collections.Counter(o for a, o, _ in insns if lo <= a <= addr)
        body = dict.fromkeys(("alu", "fma", "popc", "other"), 0)
        for o, n in ops.items():
            if o not in NOT_COUNTED:
                body[PIPES.get(o, "other")] += n
        body.update(shared=ops["LDS"] + ops["STS"], barriers=ops["BAR"],
                    total=sum(ops.values()), start=lo, end=addr)
        loops.append(body)
    return sorted(loops, key=lambda b: -b["total"])


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def counts(pq: int) -> Dict[str, Dict[str, float]]:
    """``word_step_counts`` of the probes built for the quantised force
    probability ``pq`` (``core.prng.quantize_p``)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = build.BUILD_DIR / f"op_count_pq{pq}.cubin"
    _run([build.cuda_tool("nvcc"), "-cubin", "-gencode",
          "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          f"-DPROBE_PQ={pq}", "-o", str(cubin), str(SOURCE)])
    return word_step_counts(_run([build.cuda_tool("cuobjdump"), "-sass",
                                  str(cubin)]))


def per_word_step(c: Dict[str, Dict[str, float]], record_frac: float,
                  step: str = "step") -> Dict[str, float]:
    """Pipe counts of one word-step (``step``: ``"step"``, or ``"pre"`` for
    precomputed random words) when a fraction ``record_frac`` of the steps
    also records moments."""
    return {k: c[step][k] + record_frac * c["terms"][k] for k in c[step]}


def ops_ms(word_steps: float, per_step: Dict[str, float]
           ) -> Tuple[float, str]:
    """Least milliseconds for ``word_steps`` word-steps of ``per_step``
    pipe counts, and the pipe (or ``issue``) that sets it."""
    need = dict(per_step, issue=sum(per_step.values()))
    ms = {k: word_steps * need.get(k, 0)
          / (lanes * SM_CLOCKS_PER_S) * 1e3
          for k, lanes in LANES_PER_SM_CLOCK.items()}
    pipe = max(ms, key=ms.get)
    return ms[pipe], pipe
