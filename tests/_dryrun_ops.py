"""Dot FLOPs and collective bytes of one dry-run cell, per device, op by
op: the port's (``repro_torch.launch.dryrun.run_cell``, each op of
:class:`~repro_torch.launch.op_analysis.OpAnalysis` filed under the model
line that issued it, ``backward`` for the ops of a train step's backward
pass) or the reference's (its compiled program's dots and collectives,
filed under their ``op_name``).  What names the op behind a gap between
the two packages' totals.

The reference's own count (``repro.launch.hlo_analysis.parse_hlo_stats``)
walks ``while`` bodies and ``called_computations``, but not the
computations that a ``fusion`` calls: a dot that XLA fuses counts 0.
XLA's CPU backend fuses a matrix-vector product with the convert of its
bf16 weight, so the reference's ``long_500k`` cells (a batch of one row)
count little or none of their projections.  The ``ref`` side here walks
every fusion as a call (:func:`walk_fusions`); its ``dot_flops`` is
:func:`fused_dot_flops`, beside the reference's ``hlo_flops_per_device``.

  PYTHONPATH=src python tests/_dryrun_ops.py port ARCH SHAPE [N] \
      [--multi-pod] [--spls]
  JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_dryrun_ops.py ref ARCH SHAPE \
      [N] [--multi-pod] [--spls]

prints the totals as JSON, then the ``N`` (default 30) largest entries as
``value  kind  site  shapes``.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import traceback


def _port_site() -> str:
    for fr in reversed(traceback.extract_stack()):
        path = fr.filename.replace(os.sep, "/")
        if "repro_torch/" in path and "/launch/op_analysis" not in path \
                and "/launch/dryrun" not in path:
            if "/launch/steps" in path:
                return "backward"
            return f"{path.split('repro_torch/')[1]}:{fr.lineno}"
    return "?"


def port(arch: str, shape: str, multi_pod: bool = False,
         spls: bool = False) -> tuple:
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dryrun import run_cell

    tally = collections.defaultdict(float)
    record = op_analysis.OpAnalysis._record

    def _record(self, func, args, kwargs, ins, outs, out):
        before = dict(self.stats)
        record(self, func, args, kwargs, ins, outs, out)
        for k, v in self.stats.items():
            if k != "traffic_bytes" and v != before.get(k, 0.0):
                shapes = tuple(tuple(t.shape) for t in ins[:2])
                tally[(k, _port_site(), str(shapes))] += v - before.get(
                    k, 0.0)

    op_analysis.OpAnalysis._record = _record
    try:
        res = run_cell(arch, shape, multi_pod, spls)
    finally:
        op_analysis.OpAnalysis._record = record
    return ({"dot_flops": res["hlo_flops_per_device"],
             "collective_bytes": res["collective_bytes_per_device"]}, tally)


def walk_fusions(hlo: str) -> str:
    """``hlo`` with every ``fusion`` written as a call of its computation,
    which ``parse_hlo_stats`` walks."""
    hlo = re.sub(r" fusion\(", " call(", hlo)
    return re.sub(r"calls=%([\w\.\-]+)", r"called_computations={%\1}",
                  hlo)


def fused_dot_flops(hlo: str) -> float:
    """``parse_hlo_stats(hlo)["dot_flops"]`` with the dots inside fusions
    counted too."""
    from repro.launch.hlo_analysis import parse_hlo_stats

    return parse_hlo_stats(walk_fusions(hlo))["dot_flops"]


def ref(arch: str, shape: str, multi_pod: bool = False,
        spls: bool = False) -> tuple:
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=512")
    import repro.launch.dryrun as dry
    from repro.launch import hlo_analysis as H

    texts = []
    parse = dry.parse_hlo_stats
    dry.parse_hlo_stats = lambda t: (texts.append(t), parse(t))[1]
    try:
        res = dry.run_cell(arch, shape, multi_pod=multi_pod, spls=spls)
    finally:
        dry.parse_hlo_stats = parse
    prog = H._HLO(walk_fusions(texts[0]))
    tally = collections.defaultdict(float)

    def walk(name: str, mult: int, stack: tuple) -> None:
        for ln in prog.comps.get(name, []):
            mi = H._INSTR.match(ln)
            if not mi:
                continue
            _, rshape, op = mi.groups()
            if op == "while":
                mw = H._WHILE.search(ln)
                if mw and mw.group(2) not in stack:
                    walk(mw.group(2), mult * prog.trip_count(ln, mw.group(1)),
                         stack + (name,))
                continue
            if op in ("call", "conditional", "async-start"):
                for c in re.findall(r"(?:to_apply|called_computations=\{)"
                                    r"%?([\w\.\-]+)", ln):
                    if c in prog.comps and c not in stack:
                        walk(c, mult, stack + (name,))
                continue
            m = re.search(r'op_name="([^"]*)"', ln)
            site = m.group(1).split("/")[-2:] if m else ["?"]
            site, shp = "/".join(site), rshape.split("{")[0]
            base = op.replace("-start", "")
            if base in H._COLL_OPS and not op.endswith("-done"):
                tally[(f"coll:{base}", site, shp)] += \
                    mult * H._shape_bytes(rshape)
            elif op == "dot":
                _, od = H._first_shape_dims(rshape)
                lhs = H._OPERANDS.findall(ln[ln.index("dot(") + 4:]
                                          .split(")")[0])
                _, ld = H._first_shape_dims(prog.shapes.get(lhs[0], ""))
                cd = H._DOT_CDIMS.search(ln)
                k = 1
                for i in (cd.group(1).split(",") if cd and cd.group(1)
                          else []):
                    k *= ld[int(i)]
                n = 1
                for d in od:
                    n *= d
                tally[("dot_flops", site, shp)] += mult * 2.0 * n * k
    walk(prog.entry, 1, ())
    totals = {"hlo_flops_per_device": res["hlo_flops_per_device"],
              "dot_flops": fused_dot_flops(texts[0]),
              "collective_bytes": res["collective_bytes_per_device"]}
    return totals, tally


def main(argv=None) -> None:
    args = argv or sys.argv[1:]
    flags = {a for a in args if a.startswith("--")}
    args = [a for a in args if not a.startswith("--")]
    side, arch, shape = args[:3]
    n = int(args[3]) if len(args) > 3 else 30
    multi_pod, spls = "--multi-pod" in flags, "--spls" in flags
    totals, tally = (port if side == "port" else ref)(arch, shape, multi_pod,
                                                      spls)
    print(json.dumps(dict(totals, side=side, arch=arch, shape=shape,
                          multi_pod=multi_pod, spls=spls)))
    for key, v in sorted(tally.items(), key=lambda kv: -kv[1])[:n]:
        print(f"{v:.4e}  " + "  ".join(key))


if __name__ == "__main__":
    main()
