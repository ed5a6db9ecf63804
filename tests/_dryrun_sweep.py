"""Hold the port's dry-run sweep against the reference's, cell by cell.

Reads JSON-lines files of ``python -m repro_torch.launch.dryrun_all`` (the
port) and ``python -m repro.launch.dryrun_all`` (the reference), with or
without ``--spls``, on either mesh, and checks:

  * every cell has a result or a skip, none an error;
  * a skip equals the reference's skip dict;
  * argument bytes, model FLOPs, chips, mesh, kind and ``spls`` equal the
    reference's; alias bytes are reported where they differ;
  * an ``--spls`` cell that builds no plan (decode, ``long_500k``, the
    padded musicgen-medium, the attention-free mamba2-370m) equals the
    port's cell without ``--spls`` in every key but ``trace_s`` and
    ``spls``;
  * with ``--parent``, every cell of an earlier port sweep (the same cells)
    has equal dot FLOPs, collective bytes by type and argument / output /
    alias bytes, and traffic and temp within 1 %.

Then prints one markdown table per (mesh, spls): dot FLOPs against the
reference's (its count with fused dots where ``--fused`` gives one,
``tests/_dryrun_ops.py ref``), output and temp ratios, traffic ratio,
collectives, alias; for each planning cell the SPLS-to-dense dot-FLOP
ratio of both packages; the dot-FLOP gaps over 10 %; and the sum of
``trace_s``.

  python tests/_dryrun_sweep.py --port 'port/*.jsonl' --ref 'ref/*.jsonl' \\
      [--parent 'parent/*.jsonl'] [--fused fused.json] [--compact]

``fused.json`` maps ``"arch shape mesh"`` to the reference's dot FLOPs
with fused dots.  ``--compact`` first prints one table of all four sweeps
(a row a cell: the dot-FLOP ratio, ``trace_s`` -- the parent's beside it
on 16 x 16 -- and on a planning cell both packages' SPLS-to-dense
ratios).  Exit 1 if a check fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys

_NO_PLAN_SHAPES = ("decode_32k", "long_500k")
_NO_PLAN_ARCHS = ("musicgen-medium", "mamba2-370m")
_EQUAL = ("chips", "mesh", "kind", "spls", "model_flops_total")


def load(pattern: str) -> dict:
    """``{(arch, shape, mesh, spls): result}``; the last line of a cell
    wins (a resumed sweep)."""
    out = {}
    for path in sorted(glob.glob(pattern)):
        for line in open(path):
            if line.strip():
                r = json.loads(line)
                out[(r["arch"], r["shape"], r["mesh"], r.get("spls", False))] = r
    return out


def plans(arch: str, shape: str) -> bool:
    return shape not in _NO_PLAN_SHAPES and arch not in _NO_PLAN_ARCHS


def _g(x: float) -> str:
    return f"{x:.4g}"


def check(port: dict, ref: dict, parent: dict) -> list:
    bad = []
    for key, r in sorted(ref.items()):
        p = port.get(key)
        if p is None:
            bad.append(f"{key}: no port result")
            continue
        if "error" in p:
            bad.append(f"{key}: {p['error'][-300:]}")
            continue
        if r.get("skipped"):
            if p != r:
                bad.append(f"{key}: skip {p} != the reference's {r}")
            continue
        if "error" in r:
            bad.append(f"{key}: the reference's run failed")
            continue
        for k in _EQUAL:
            if p.get(k) != r.get(k):
                bad.append(f"{key}: {k} {p.get(k)} != {r.get(k)}")
        a, b = (x["memory"]["argument_bytes_per_device"] for x in (p, r))
        if a != b:
            bad.append(f"{key}: argument bytes {a} != {b}")
        arch, shape, mesh, spls = key
        if spls and not plans(arch, shape):
            dense = port.get((arch, shape, mesh, False))
            strip = lambda d: {k: v for k, v in d.items()
                               if k not in ("trace_s", "spls")}
            if dense is None or strip(dense) != strip(p):
                bad.append(f"{key}: differs from its cell without --spls")
    for key, q in sorted(parent.items()):
        p = port.get(key)
        if q.get("skipped") or p is None or "error" in p or "error" in q:
            if p is None or ("error" in p) != ("error" in q):
                bad.append(f"{key}: parent {q.get('error', 'ok')}, now "
                           f"{(p or {}).get('error', 'ok')}")
            continue
        for k in ("hlo_flops_per_device", "collective_breakdown"):
            if p[k] != q[k]:
                bad.append(f"{key}: {k} {p[k]} != parent's {q[k]}")
        for k in ("argument_bytes_per_device", "output_bytes_per_device",
                  "alias_bytes_per_device"):
            if p["memory"][k] != q["memory"][k]:
                bad.append(f"{key}: {k} {p['memory'][k]} != parent's "
                           f"{q['memory'][k]}")
        for a, b, what in (
                (p["hlo_bytes_per_device"], q["hlo_bytes_per_device"],
                 "traffic"),
                (p["memory"]["temp_bytes_per_device"],
                 q["memory"]["temp_bytes_per_device"], "temp")):
            if abs(a - b) > 0.01 * b:
                bad.append(f"{key}: {what} {a} vs parent's {b}")
    return bad


def parent_diffs(port: dict, parent: dict) -> list:
    """Cells whose traffic or temp moved against the parent's, and by how
    much (relative)."""
    rows = []
    for key, q in sorted(parent.items()):
        p = port.get(key)
        if q.get("skipped") or p is None or "error" in p:
            continue
        dt = p["hlo_bytes_per_device"] / q["hlo_bytes_per_device"] - 1
        dm = (p["memory"]["temp_bytes_per_device"]
              / q["memory"]["temp_bytes_per_device"] - 1)
        if dt or dm:
            rows.append(f"{' '.join(map(str, key[:3]))}: traffic {dt:+.3e}, "
                        f"temp {dm:+.3e}")
    return rows


def table(port: dict, ref: dict, fused: dict, mesh: str, spls: bool) -> list:
    out = ["| cell | trace s | dot FLOPs/dev port / ref | output; temp ratio "
           "| traffic ratio | collectives B/dev port / ref | alias port / "
           "ref |", "| --- | --- | --- | --- | --- | --- | --- |"]
    gaps, total = [], 0.0
    for key in sorted(k for k in ref if k[2] == mesh and k[3] == spls):
        arch, shape = key[:2]
        r, p = ref[key], port.get(key, {})
        name = f"{arch} {shape}"
        if r.get("skipped"):
            out.append(f"| {name} | skipped: the reference's dict | | | | "
                       f"| |")
            continue
        if "error" in p or not p:
            out.append(f"| {name} | {'error' if p else 'no result'} | | | "
                       f"| | |")
            continue
        total += p["trace_s"]
        pf, rf = p["hlo_flops_per_device"], r["hlo_flops_per_device"]
        fk = f"{arch} {shape} {mesh}"
        den = fused.get(fk, rf)
        ratio = pf / den if den else float("inf")
        fl = (f"{_g(pf)} / {_g(rf)} (fused {_g(den)}) = {ratio:.3g}"
              if fk in fused else f"{_g(pf)} / {_g(rf)} = {ratio:.3g}")
        if abs(ratio - 1) > 0.1:
            gaps.append(f"{name}: {ratio:.3g}")
        pm, rm = p["memory"], r["memory"]
        ro = pm["output_bytes_per_device"] / max(rm["output_bytes_per_device"],
                                                 1)
        rt = pm["temp_bytes_per_device"] / max(rm["temp_bytes_per_device"], 1)
        tr = p["hlo_bytes_per_device"] / r["hlo_bytes_per_device"]
        pc, rc = (p["collective_bytes_per_device"],
                  r["collective_bytes_per_device"])
        cr = pc / rc if rc else float("inf")
        al = ("=" if pm["alias_bytes_per_device"] == rm[
            "alias_bytes_per_device"] else f"{_g(pm['alias_bytes_per_device'])}"
              f" / {_g(rm['alias_bytes_per_device'])}")
        out.append(f"| {name} | {p['trace_s']} | {fl} | {ro:.3g}; {rt:.3g} "
                   f"| {tr:.3g} | {_g(pc)} / {_g(rc)} = {cr:.3g} | {al} |")
    out.append(f"\nSum of trace_s {total:.1f} s.  Dot-FLOP gaps over 10 %: "
               f"{'; '.join(gaps) or 'none'}.")
    return out


def spls_ratios(port: dict, ref: dict, mesh: str) -> list:
    out = ["| cell | port SPLS / dense dot FLOPs | reference SPLS / dense | "
           "port / reference (SPLS) |", "| --- | --- | --- | --- |"]
    for key in sorted(k for k in ref if k[2] == mesh and k[3]):
        arch, shape = key[:2]
        if not plans(arch, shape) or ref[key].get("skipped"):
            continue
        dk = (arch, shape, mesh, False)
        try:
            ps, pd = (port[k]["hlo_flops_per_device"] for k in (key, dk))
            rs, rd = (ref[k]["hlo_flops_per_device"] for k in (key, dk))
        except KeyError:
            out.append(f"| {arch} {shape} | missing | | |")
            continue
        out.append(f"| {arch} {shape} | {_g(ps)} / {_g(pd)} = {ps / pd:.3f} "
                   f"| {_g(rs)} / {_g(rd)} = {rs / rd:.3f} | {ps / rs:.3f} |")
    return out


def _cell(port: dict, ref: dict, fused: dict, key, parent: dict) -> str:
    """``ratio (trace s)`` of one cell for :func:`compact`: dot FLOPs
    against the reference's (fused where given); ``parent's trace ->``
    before it with a parent; ``; SPLS/dense port / ref`` on a planning
    ``--spls`` cell."""
    arch, shape, mesh, spls = key
    r, p = ref.get(key, {}), port.get(key)
    if r.get("skipped"):
        return "skip"
    if not p or "error" in p:
        return "error" if p else "no result"
    den = fused.get(f"{arch} {shape} {mesh}", r["hlo_flops_per_device"])
    out = f"{p['hlo_flops_per_device'] / den:.3g}"
    q = parent.get(key)
    t = p["trace_s"] if q is None else f"{q['trace_s']} -> {p['trace_s']}"
    out += f" ({t} s)"
    if spls and plans(arch, shape):
        dk = (arch, shape, mesh, False)
        if "hlo_flops_per_device" in port.get(dk, {}) and dk in ref:
            ps = p["hlo_flops_per_device"] / port[dk]["hlo_flops_per_device"]
            rs = r["hlo_flops_per_device"] / ref[dk]["hlo_flops_per_device"]
            out += f"; {ps:.3f} / {rs:.3f}"
    return out


def compact(port: dict, ref: dict, fused: dict, parent: dict) -> list:
    """One row a cell, one column a sweep (:func:`_cell`); the reference's
    skips in one line."""
    cols = [("16x16", False), ("2x16x16", False), ("16x16", True),
            ("2x16x16", True)]
    out = ["| cell | 16x16 | 2x16x16 | --spls 16x16 | --spls 2x16x16 |",
           "| --- | --- | --- | --- | --- |"]
    cells = sorted({k[:2] for k in ref})
    skipped = [f"{a} {s}" for a, s in cells
               if all(ref.get((a, s, m, p), {}).get("skipped")
                      for m, p in cols)]
    for a, s in cells:
        if f"{a} {s}" in skipped:
            continue
        row = [_cell(port, ref, fused, (a, s, m, p),
                     parent if (m, p) == ("16x16", False) else {})
               for m, p in cols]
        out.append(f"| {a} {s} | " + " | ".join(row) + " |")
    out.append(f"\nSkipped in all four sweeps (the reference's dict): "
               f"{', '.join(skipped)}.")
    for m, p in cols:
        tot = sum(r["trace_s"] for k, r in port.items()
                  if k[2:] == (m, p) and "trace_s" in r)
        out.append(f"Sum of trace_s, {m}{' --spls' if p else ''}: "
                   f"{tot:.1f} s.")
    if parent:
        tot = sum(r.get("trace_s", 0) for r in parent.values())
        out.append(f"Sum of trace_s, the parent's 16x16: {tot:.1f} s.")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", required=True)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--fused", default=None)
    ap.add_argument("--compact", action="store_true",
                    help="one table: a row a cell, a column a sweep")
    args = ap.parse_args(argv)
    port, ref = load(args.port), load(args.ref)
    parent = load(args.parent) if args.parent else {}
    fused = json.load(open(args.fused)) if args.fused else {}
    if args.compact:
        print("\n".join(compact(port, ref, fused, parent)))
    for mesh in ("16x16", "2x16x16"):
        for spls in (False, True):
            if any(k[2] == mesh and k[3] == spls for k in ref):
                print(f"\n### {mesh}{' --spls' if spls else ''}\n")
                print("\n".join(table(port, ref, fused, mesh, spls)))
        if any(k[2] == mesh and k[3] for k in ref):
            print(f"\n#### SPLS-to-dense dot FLOPs, {mesh}\n")
            print("\n".join(spls_ratios(port, ref, mesh)))
    if parent:
        print("\n### against the parent's sweep (traffic, temp moved)\n")
        print("\n".join(parent_diffs(port, parent)) or "none")
    bad = check(port, ref, parent)
    print(f"\n{len(bad)} failed checks" + "".join(f"\n  {b}" for b in bad))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
