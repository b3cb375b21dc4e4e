"""The yardstick of the dry-run's memory term: the JAX package's own
``dryrun_one`` rows, XLA's memory analysis of each compiled step (one
device's temp, output and peak bytes), and the bytes of the float32 copies
of whole bfloat16 step arguments that XLA:CPU makes in its temp.

XLA's CPU backend computes bfloat16 in float32: it converts a bf16 weight or
cache that an op reads whole into a float32 copy first, and keeps the copy
in its temp. A device with bf16 arithmetic makes no such copy, and neither
does the port, so the port's ``temp_bytes`` is held to the reference's less
those copies (``chip_smoke.py:memory_ratio_ok``). A copy is counted where
the entry computation of the optimised HLO converts (a ``convert``, or a
loop fusion named for one) an entry parameter of bf16 into float32 of the
same shape; copies of a parameter's slices inside a loop are not counted.

Run from the root of the repo (a few minutes; the JAX package's dry-run
asks for 512 host devices when imported)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/reference_memory.py

prints ``chip_smoke.py``'s ``DRYRUN_MEM_REFERENCE`` (every single-pod row of
``--all``) and ``DRYRUN_MEM_LREMAT_REFERENCE`` (each ``train_4k`` row with
``--layer-remat``).
"""

from __future__ import annotations

import math
import re

_ITEM = {"f32": 4, "bf16": 2}
_LINE = re.compile(r"\s*(?:ROOT )?%([\w.\-]+) = (\w+)\[([\d,]*)\]\S* "
                   r"([\w\-]+)\((.*)")


def f32_argument_copies(hlo: str) -> int:
    """Bytes of the float32 copies of whole bf16 entry parameters that the
    entry computation of ``hlo`` (a compiled module's ``as_text()``)
    makes."""
    entry = hlo[hlo.index("\nENTRY"):]
    params, total = {}, 0
    for line in entry.splitlines()[1:]:
        if line.startswith("}"):
            break
        m = _LINE.match(line)
        if m is None:
            continue
        name, dtype, dims, op, rest = m.groups()
        if op == "parameter":
            params[name] = (dtype, dims)
            continue
        operands = re.findall(r"%([\w.\-]+)", rest.split(")")[0])
        if dtype == "f32" and len(operands) == 1 and \
                params.get(operands[0]) == ("bf16", dims) and \
                (op == "convert" or (op == "fusion" and "convert" in name)):
            total += _ITEM["f32"] * math.prod(
                int(d) for d in dims.split(",") if d)
    return total


def reference_rows(rows, layer_remat: bool = False) -> list[dict]:
    """``repro.launch.dryrun.dryrun_one`` of each ``(arch, shape)`` in
    ``rows``, each row with ``f32_copies``: :func:`f32_argument_copies` of
    its step's compiled module."""
    import jax

    import repro.launch.dryrun as d

    compiled = []
    real = jax.stages.Lowered.compile

    def compile_(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        compiled.append(out)
        return out

    jax.stages.Lowered.compile = compile_
    try:
        out = []
        for arch, shape in rows:
            compiled.clear()
            row = d.dryrun_one(arch, shape, verbose=False,
                               layer_remat=layer_remat)
            # the step's compile comes first; block_cost's follow it
            row["f32_copies"] = f32_argument_copies(compiled[0].as_text())
            out.append(row)
        return out
    finally:
        jax.stages.Lowered.compile = real


def main() -> None:
    import repro.launch.dryrun as d
    from repro.configs import ARCHS

    print("DRYRUN_MEM_REFERENCE = {")
    for r in reference_rows([(a, s) for a in ARCHS for s in d.SHAPES]):
        print(f"    ({r['arch']!r}, {r['shape'].split('(')[0]!r}): "
              f"({r['temp_bytes']}, {r['output_bytes']},\n"
              f"        {r['peak_bytes']}, {r['f32_copies']}),")
    print("}\nDRYRUN_MEM_LREMAT_REFERENCE = {")
    for r in reference_rows([(a, "train_4k") for a in ARCHS],
                            layer_remat=True):
        print(f"    {r['arch']!r}: ({r['temp_bytes']}, {r['f32_copies']}),")
    print("}")


if __name__ == "__main__":
    main()
