"""Generate the CUDA rule circuits (``csrc/rules_gen.cuh``) from the rule
specs, so the kernel's circuits cannot drift from the rule table.

The port's own ``RuleSpec.collide`` / ``force`` (``core.boolean`` for FHP,
``core.rulespec._bml_collide`` for BML) are called on symbolic words: each
``& | ^ ~`` appends one SSA line ``const uint32_t xN = a OP b;``, repeated
sub-expressions are shared, and lines no output reaches are dropped.  The
taps and the ``MomentSpec`` popcount terms come from the same specs.

    python -m repro_torch.kernels.fhp_step.codegen     # rewrite the header

The header is checked in; a CPU test regenerates it and compares bytes.
"""
from __future__ import annotations

import pathlib
from typing import Dict, List, Sequence, Tuple

from repro_torch.core import rulespec

RULES = ("fhp2", "fhp3", "bml")          # rule id = index, as in ops.py
HEADER = pathlib.Path(__file__).with_name("csrc") / "rules_gen.cuh"


class _Prog:
    """An SSA program of 32-bit boolean operations."""

    def __init__(self):
        self.lines: List[Tuple[str, str, Tuple[str, ...]]] = []
        self._memo: Dict[Tuple[str, ...], "_Sym"] = {}

    def var(self, name: str) -> "_Sym":
        return _Sym(self, name)

    def op(self, op: str, *args: "_Sym") -> "_Sym":
        names = tuple(a.name for a in args)
        if op in "&|^":
            names = tuple(sorted(names))
        key = (op,) + names
        if key not in self._memo:
            name = f"x{len(self.lines)}"
            expr = f"~{names[0]}" if op == "~" else f" {op} ".join(names)
            self.lines.append((name, expr, names))
            self._memo[key] = _Sym(self, name)
        return self._memo[key]

    def live(self, outputs: Sequence["_Sym"]):
        """The lines some output depends on, in program order."""
        need = {o.name for o in outputs}
        keep = []
        for name, expr, deps in reversed(self.lines):
            if name in need:
                keep.append((name, expr))
                need.update(deps)
        return keep[::-1]


class _Sym:
    __slots__ = ("prog", "name")

    def __init__(self, prog: _Prog, name: str):
        self.prog, self.name = prog, name

    def __and__(self, o):
        return self.prog.op("&", self, o)

    def __or__(self, o):
        return self.prog.op("|", self, o)

    def __xor__(self, o):
        return self.prog.op("^", self, o)

    def __invert__(self):
        return self.prog.op("~", self)


def _circuit(fn, in_names: Sequence[str], extra: Dict[str, str],
             out_name: str, indent: str) -> Tuple[List[str], int]:
    """C lines computing ``fn(inputs, **extra)`` into ``out_name[i]`` and
    the number of boolean operations they execute."""
    prog = _Prog()
    ins = [prog.var(n) for n in in_names]
    outs = fn(ins, **{k: prog.var(v) for k, v in extra.items()})
    body = prog.live(outs)
    lines = [f"{indent}const uint32_t {n} = {e};" for n, e in body]
    for i, o in enumerate(outs):
        if o.name != f"{out_name}[{i}]":
            lines.append(f"{indent}{out_name}[{i}] = {o.name};")
    return lines, len(body)


def circuit_ops(variant: str) -> Dict[str, int]:
    """Boolean operations per word of each generated circuit: ``collide``
    (for BML the larger of its two sub-steps) and ``force``."""
    spec = rulespec.get_rule(variant)
    v = [f"v[{i}]" for i in range(len(spec.taps))]
    if spec.n_substeps == 2:
        n = max(_circuit(lambda a, t=t: spec.collide(a, None, t), v, {},
                         "o", "")[1] for t in (0, 1))
    else:
        n = _circuit(lambda a, chi: spec.collide(a, chi, 0), v,
                     {"chi": "chi"}, "o", "")[1]
    f = 0
    if spec.force is not None:
        o = [f"o[{i}]" for i in range(spec.n_planes)]
        f = _circuit(lambda a, acc: spec.force(a, acc), o,
                     {"acc": "acc"}, "o", "")[1]
    return {"collide": n, "force": f}


def _moment_fns(ms: rulespec.MomentSpec, suffix: str) -> List[str]:
    ind = "    "
    out = [f"  static const int N_TERMS{suffix} = {ms.n_terms};",
           f"  static const int N_MOMENTS{suffix} = {ms.n_moments};",
           f"  static __host__ __device__ __forceinline__ void "
           f"terms{suffix.lower()}(const uint32_t* p, int* c) {{"]
    for i, t in enumerate(ms.terms):
        word = f"p[{t[0]}]" if len(t) == 1 else f"(p[{t[0]}] & p[{t[1]}])"
        out.append(f"{ind}c[{i}] += popc32({word});")
    out += ["  }",
            f"  static __host__ __device__ __forceinline__ void "
            f"combine{suffix.lower()}(const int* c, int* m) {{"]
    for r, (name, row) in enumerate(zip(ms.names, ms.coeffs)):
        parts = []
        for i, c in enumerate(row):
            if c:
                sign = "-" if c < 0 else "+"
                mag = "" if abs(c) == 1 else f"{abs(c)} * "
                parts.append(f"{sign} {mag}c[{i}]")
        expr = " ".join(parts).lstrip("+ ") if parts else "0"
        if expr.startswith("- "):
            expr = "-" + expr[2:]
        out.append(f"{ind}m[{r}] = {expr};  // {name}")
    out.append("  }")
    return out


def _rule_struct(variant: str, rule_id: int) -> List[str]:
    spec = rulespec.get_rule(variant)
    ind = "    "
    sp = -1 if spec.solid_plane is None else spec.solid_plane
    ops = circuit_ops(variant)
    out = [f"// rule {rule_id}: {variant} -- {spec.n_planes} planes, "
           f"{len(spec.taps)} taps, collide {ops['collide']} ops, "
           f"force {ops['force']} ops per word",
           f"struct Rule_{variant} {{",
           f"  static const int ID = {rule_id};",
           f"  static const int NP = {spec.n_planes};",
           f"  static const int NTAPS = {len(spec.taps)};",
           f"  static const int SOLID = {sp};",
           f"  static const bool NEEDS_RNG = "
           f"{'true' if spec.needs_rng else 'false'};",
           f"  static const bool HAS_FORCE = "
           f"{'true' if spec.force is not None else 'false'};",
           "  template <class Rd>",
           "  static __host__ __device__ __forceinline__ void "
           "taps(const Rd& rd, uint32_t* v) {"]
    for i, tap in enumerate(spec.taps):
        (dx0, dy), (dx1, _) = tap.offsets
        out.append(f"{ind}v[{i}] = rd.tap({tap.plane}, {dx0}, {dx1}, {dy});")
    out += ["  }",
            "  static __host__ __device__ __forceinline__ void "
            "collide(const uint32_t* v, uint32_t chi, uint32_t t, "
            "uint32_t* o) {"]
    v = [f"v[{i}]" for i in range(len(spec.taps))]
    if spec.n_substeps == 2:
        out.append(f"{ind}(void)chi;")
        for t, head in ((0, "if ((t & 1u) == 0u) {"), (1, "} else {")):
            lines, _ = _circuit(lambda a, t=t: spec.collide(a, None, t),
                                v, {}, "o", ind + "  ")
            out += [ind + head] + lines
        out.append(ind + "}")
    else:
        out.append(f"{ind}(void)t;")
        if not spec.needs_rng:
            out.append(f"{ind}(void)chi;")
        lines, _ = _circuit(lambda a, chi: spec.collide(a, chi, 0), v,
                            {"chi": "chi"} if spec.needs_rng else {},
                            "o", ind)
        out += lines
    out.append("  }")
    if spec.force is not None:
        out.append("  static __host__ __device__ __forceinline__ void "
                   "force(uint32_t* o, uint32_t acc) {")
        o = [f"o[{i}]" for i in range(spec.n_planes)]
        lines, _ = _circuit(lambda a, acc: spec.force(a, acc), o,
                            {"acc": "acc"}, "o", ind)
        out += lines + ["  }"]
    else:
        out.append("  static __host__ __device__ __forceinline__ void "
                   "force(uint32_t*, uint32_t) {}")
    out += _moment_fns(rulespec.moment_spec(spec), "")
    if spec.solid_plane is not None:
        out += _moment_fns(rulespec.moment_spec(
            spec, stack_planes=spec.n_planes - 1), "_STATIC")
    out.append("};")
    return out


def generate() -> str:
    """The text of ``csrc/rules_gen.cuh``."""
    lines = ["// Generated by `python -m repro_torch.kernels.fhp_step.codegen`"
             " from",
             "// repro_torch.core.rulespec; do not edit by hand.",
             "#pragma once",
             ""]
    for i, name in enumerate(RULES):
        lines += _rule_struct(name, i) + [""]
    lines.append("#define FHP_FOR_EACH_RULE(X) "
                 + " ".join(f"X(Rule_{n})" for n in RULES))
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    HEADER.write_text(generate())
    print(f"wrote {HEADER}")
