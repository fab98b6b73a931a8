#!/usr/bin/env python3
"""Extract wavelet filter tap tables (numeric data) from the reference Java sources.

The reference (/root/reference, Prophetizo/JWave-Pro) hardcodes standard published
wavelet filter coefficients (Daubechies, Symlets, Coiflets, Biorthogonal splines,
Legendre, Discrete Meyer, ...) inside Java class constructors, e.g.
``src/main/java/jwave/transforms/wavelets/daubechies/Daubechies4.java:50-62``.
These numbers are mathematical constants (the same tables PyWavelets ships); this
script extracts them *as data* so the JAX framework reproduces the reference
numerics exactly.  No code is copied — only numeric constants are evaluated.

Java expression evaluation is done with a restricted AST walker (numbers,
+ - * / unary-minus, parentheses, Math.sqrt/Math.PI and previously declared
``double`` locals).  Post-processing loops of the form
``for(...) _scalingDeCom[i] /= expr;`` (used by the Legendre family,
``legendre/Legendre1.java:60-63``) are applied as a whole-array divide.

Output: jwave_pro/wavelets/_taps.py  (dict: name -> {dec_lo, [dec_hi], meta})
"""
from __future__ import annotations

import ast
import math
import re
import sys
from pathlib import Path

REF = Path("/root/reference/src/main/java/jwave/transforms/wavelets")
OUT = Path(__file__).resolve().parent.parent / "jwave_pro" / "wavelets" / "_taps.py"

_DECL_RE = re.compile(r"double\s+(\w+)\s*=\s*([^;]+);")
_ASSIGN_RE = re.compile(r"_(scalingDeCom|waveletDeCom|scalingReCon|waveletReCon)\[\s*(\d+)\s*\]\s*=\s*([^;]+);")
_DIVEQ_RE = re.compile(r"_(scalingDeCom|waveletDeCom|scalingReCon|waveletReCon)\[\s*i\s*\]\s*/=\s*([^;]+);")
_META_RE = re.compile(r"_motherWavelength\s*=\s*(\d+)\s*;")
_TWL_RE = re.compile(r"_transformWavelength\s*=\s*(\d+)\s*;")
_NAME_RE = re.compile(r'_name\s*=\s*"([^"]+)"')


def _java_to_py(expr: str) -> str:
    expr = expr.replace("Math.sqrt", "sqrt").replace("Math.PI", "PI")
    expr = expr.replace("Math.pow", "pow")
    return expr


class _SafeEval(ast.NodeVisitor):
    """Evaluate a numeric expression with a whitelist of node types."""

    def __init__(self, env):
        self.env = env

    def visit(self, node):  # noqa: D102
        if isinstance(node, ast.Expression):
            return self.visit(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return float(node.value)
        if isinstance(node, ast.Name):
            return self.env[node.id]
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("_scalingDeCom", "_waveletDeCom")
            and isinstance(node.slice, ast.Constant)
        ):
            # e.g. Haar1: _waveletDeCom[0] = _scalingDeCom[1]  (haar/Haar1.java:59-61)
            bank = self.env["__banks__"][node.value.id.lstrip("_")]
            return bank[node.slice.value]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
            v = self.visit(node.operand)
            return -v if isinstance(node.op, ast.USub) else v
        if isinstance(node, ast.BinOp):
            a, b = self.visit(node.left), self.visit(node.right)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Div):
                return a / b
            raise ValueError(f"op {node.op}")
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            args = [self.visit(a) for a in node.args]
            if node.func.id == "sqrt":
                return math.sqrt(args[0])
            if node.func.id == "pow":
                return math.pow(*args)
            raise ValueError(f"call {node.func.id}")
        raise ValueError(f"node {ast.dump(node)}")


def ev(expr: str, env) -> float:
    return _SafeEval(env).visit(ast.parse(_java_to_py(expr.strip()), mode="eval"))


def strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    src = re.sub(r"//[^\n]*", "", src)
    return src


def extract(path: Path):
    src = strip_comments(path.read_text())
    m = _META_RE.search(src)
    if not m:
        return None
    length = int(m.group(1))
    if length == 0:
        return None  # abstract base (Wavelet.java:85)
    name_m = _NAME_RE.search(src)
    twl_m = _TWL_RE.search(src)
    env = {"PI": math.pi}
    for dm in _DECL_RE.finditer(src):
        var, expr = dm.group(1), dm.group(2)
        try:
            env[var] = ev(expr, env)
        except Exception:
            pass  # non-numeric local, ignore
    bank_names = ("scalingDeCom", "waveletDeCom", "scalingReCon",
                  "waveletReCon")
    banks = {b: [None] * length for b in bank_names}
    env["__banks__"] = banks
    n_assigned = {b: 0 for b in bank_names}
    for am in _ASSIGN_RE.finditer(src):
        bank, idx, expr = am.group(1), int(am.group(2)), am.group(3)
        banks[bank][idx] = ev(expr, env)
        n_assigned[bank] += 1
    for dm in _DIVEQ_RE.finditer(src):
        bank, expr = dm.group(1), dm.group(2)
        d = ev(expr, env)
        banks[bank] = [v / d if v is not None else None for v in banks[bank]]
    out = {
        "java_class": path.stem,
        "name": name_m.group(1) if name_m else path.stem,
        "transform_wavelength": int(twl_m.group(1)) if twl_m else 2,
        "length": length,
    }
    if n_assigned["scalingDeCom"] == length:
        out["dec_lo"] = banks["scalingDeCom"]
    else:
        return None  # base/abstract class
    if n_assigned["waveletDeCom"] == length:
        out["dec_hi"] = banks["waveletDeCom"]
    if n_assigned["scalingReCon"] == length:
        out["rec_lo"] = banks["scalingReCon"]
    if n_assigned["waveletReCon"] == length:
        out["rec_hi"] = banks["waveletReCon"]
    # Which QMF builder the constructor actually calls (comments stripped):
    if "_buildBiOrthonormalSpace" in src:
        out["builder"] = "biorthogonal"
    elif "_buildOrthonormalSpace" in src:
        out["builder"] = "orthonormal"
    else:
        out["builder"] = "explicit"
    out["family"] = path.parent.name
    return out


def main():
    entries = []
    for p in sorted(REF.rglob("*.java")):
        if p.parent.name == "continuous":
            continue
        try:
            e = extract(p)
        except Exception as exc:  # noqa: BLE001
            print(f"FAIL {p.name}: {exc}", file=sys.stderr)
            continue
        if e:
            entries.append(e)
    lines = [
        '"""Wavelet filter tap tables (generated by tools/extract_taps.py — do not edit).',
        "",
        "Standard published wavelet filter coefficients, extracted as numeric data from",
        "the reference implementation for exact numerical parity (e.g.",
        "jwave/transforms/wavelets/daubechies/Daubechies4.java:50-62).",
        '"""',
        "",
        "TAPS = {",
    ]
    for e in entries:
        lines.append(f"    {e['java_class']!r}: {{")
        lines.append(f"        'name': {e['name']!r},")
        lines.append(f"        'family': {e['family']!r},")
        lines.append(f"        'builder': {e['builder']!r},")
        lines.append(f"        'transform_wavelength': {e['transform_wavelength']},")
        lines.append("        'dec_lo': [")
        for v in e["dec_lo"]:
            lines.append(f"            {v!r},")
        lines.append("        ],")
        for key in ("dec_hi", "rec_lo", "rec_hi"):
            if key in e:
                lines.append(f"        {key!r}: [")
                for v in e[key]:
                    lines.append(f"            {v!r},")
                lines.append("        ],")
        lines.append("    },")
    lines.append("}")
    OUT.write_text("\n".join(lines) + "\n")
    print(f"wrote {OUT} with {len(entries)} wavelets")


if __name__ == "__main__":
    main()
