"""Rule family 4 — **CUDA kernel safety** (``cuda-kernel-safety``).

The hand kernels hold the reference's bytes only under a few source-level
disciplines that nothing in the compiler enforces — a lost flag or one
rewritten line changes the rounding, and the bytes, without an error.
This family lints them over ``ops/csrc/*.cu``, ``*.cuh`` and
``ops/_build.py`` (text and ``ast``; nothing is compiled). Five detectors,
each named at the head of its message:

``fmad-false``
    ``_build.NVCC_FLAGS`` carries ``-fmad=false`` and no fast-math
    (``--use_fast_math`` flushes subnormals; ``-fmad=true`` contracts
    every ``a*b+c`` the source wrote as two roundings).
``explicit-fma``
    Every update the reference rounds once is an explicit ``__fmaf_rn``:
    a rate (``r``, ``r_l``, ``maskr``) times a field term may appear only
    inside an ``__fmaf_rn(...)`` (the decay form's separately rounded
    ``maskr * sum`` is such an argument); ``c + r * lap`` elsewhere rounds
    twice under ``-fmad=false``. Every lane kernel source fuses its
    update at least once.
``select-not-mask``
    No multiply-mask in ``lanes_common.cuh`` or the lane policies
    (``struct LaneCells``): a lane keeps a cell's value by a select
    (``live ? u : c``, or the masks' bitwise select), never by
    ``c + mask * (u - c)``, which turns a NaN or an infinity in a frozen
    cell into a different value than the reference's ``where``.
``storage-round``
    The lane kernels round to the storage type every step: each lane
    policy's ``keep`` rounds (``__floats2bfloat162_rn`` / ``to_storage``),
    every fused lane update outside a policy is wrapped in
    ``to_storage<T>(...)``, and ``lanes_common.cuh``'s bf16
    ``to_storage`` rounds to nearest even (``__float2bfloat16_rn``).
``cuh-shipped``
    Every ``csrc/*.cu`` and ``*.cuh`` is in ``pyproject.toml``'s package
    data (an installed package must build), and every header is part of
    ``_build``'s library hash (a changed header must build anew).

Sanctioned exceptions take ``// heat-tpu: allow[cuda-kernel-safety]
reason`` in a CUDA source, or the ``#`` form in ``_build.py``.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .core import Context, Violation, attr_chain, register

RULE = "cuda-kernel-safety"
CSRC = "ops/csrc/"
BUILD = "ops/_build.py"
LANE_SOURCES = ("lanes2d.cu", "lanes3d.cu")
LANES_COMMON = "lanes_common.cuh"
POLICY = "LaneCells"

_RATES = ("r", "r_l", "maskr")
_TYPES = {"float", "double", "int", "void", "char", "unsigned", "T",
          "__nv_bfloat16", "__nv_bfloat162", "int64_t", "int32_t",
          "uint32_t", "size_t", "auto", "const", "bool"}
_MASK_RE = re.compile(r"^\w*(mask|live|keep)\w*$")
_IDENT_RE = re.compile(r"[A-Za-z_]\w*")
_FAST_MATH = ("--use_fast_math", "-use_fast_math", "-fmad=true",
              "--fmad=true", "-ftz=true", "--ftz=true")
_STORAGE_ROUNDS = ("__floats2bfloat162_rn", "to_storage",
                   "__float2bfloat16_rn")


def strip_comments(text: str) -> str:
    """``text`` with every ``//`` and ``/* */`` comment blanked out (newlines
    kept, so offsets map to the same lines)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(c if c == "\n" else " " for c in text[i:j]))
            i = j
        elif text[i] == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def _line_of(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Offset of the bracket closing the one at ``i``, or -1."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j
    return -1


def _match_back(text: str, i: int, open_: str, close: str) -> int:
    """Offset of the bracket opening the one closing at ``i``, or -1."""
    depth = 0
    for j in range(i, -1, -1):
        if text[j] == close:
            depth += 1
        elif text[j] == open_:
            depth -= 1
            if depth == 0:
                return j
    return -1


def call_spans(text: str, name: str) -> List[Tuple[int, int]]:
    """``(open paren, close paren)`` offsets of every ``name(...)`` call."""
    spans = []
    for m in re.finditer(r"\b" + re.escape(name) + r"\s*(<[^;>]*>)?\s*\(",
                         text):
        o = m.end() - 1
        c = _match(text, o, "(", ")")
        if c > 0:
            spans.append((o, c))
    return spans


def blocks(text: str, head: str) -> List[Tuple[int, int]]:
    """``(start, end)`` offsets of every brace block opened after a match
    of the regex ``head`` (a struct or function)."""
    out = []
    for m in re.finditer(head, text):
        o = text.find("{", m.end())
        if o < 0:
            continue
        c = _match(text, o, "{", "}")
        if c > 0:
            out.append((m.start(), c))
    return out


def _inside(spans, offset: int) -> bool:
    return any(o < offset < c for o, c in spans)


def _operand_left(text: str, i: int) -> Optional[List[str]]:
    """Identifiers of the operand left of the ``*`` at ``i``; None when the
    ``*`` is no multiplication (a pointer declaration or a dereference)."""
    j = i - 1
    while j >= 0 and text[j] in " \t\n":
        j -= 1
    if j < 0:
        return None
    if text[j] in ")]":
        o = _match_back(text, j, "(" if text[j] == ")" else "[",
                        text[j])
        if o < 0:
            return None
        k = o - 1
        while k >= 0 and (text[k].isalnum() or text[k] == "_"):
            k -= 1
        base = _IDENT_RE.findall(text[k + 1:o])
        return base + _IDENT_RE.findall(text[o:j + 1])
    m = re.search(r"([A-Za-z_]\w*|[0-9][\w.]*)$", text[:j + 1])
    if m is None:
        return None
    word = m.group(1)
    if word in _TYPES:
        return None
    return [word] if not word[0].isdigit() else []


def _operand_right(text: str, i: int) -> List[str]:
    """Identifiers of the operand right of the ``*`` at ``i`` (a cast is
    skipped; a parenthesized group gives all of its identifiers)."""
    j = i + 1
    while j < len(text) and text[j] in " \t\n":
        j += 1
    cast = re.match(r"\(\s*(float|int|unsigned|double)\s*\)\s*", text[j:])
    if cast:
        j += cast.end()
    if j < len(text) and text[j] == "(":
        c = _match(text, j, "(", ")")
        return _IDENT_RE.findall(text[j:c + 1]) if c > 0 else []
    m = re.match(r"[A-Za-z_]\w*", text[j:])
    return [m.group(0)] if m else []


def products(text: str):
    """``(offset, left identifiers, right identifiers)`` of every binary
    multiplication in comment-stripped C source."""
    for m in re.finditer(r"\*", text):
        i = m.start()
        if text[i + 1:i + 2] in ("=", "*") or text[i - 1:i] == "*":
            continue
        left = _operand_left(text, i)
        if left is None:
            continue
        yield i, left, _operand_right(text, i)


# --- the detectors -----------------------------------------------------------

def _fmad_false(ctx: Context) -> List[Violation]:
    src = ctx.source(BUILD)
    if src is None:
        return []
    for node in src.tree.body:
        if not (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "NVCC_FLAGS"
                for t in node.targets)):
            continue
        flags = [e.value for e in getattr(node.value, "elts", ())
                 if isinstance(e, ast.Constant) and isinstance(e.value, str)]
        out = []
        if "-fmad=false" not in flags:
            out.append(Violation(
                RULE, src.rel, node.lineno,
                "fmad-false: NVCC_FLAGS lacks -fmad=false — nvcc then "
                "contracts every a*b+c the kernels wrote as two roundings "
                "into one FMA, and the bytes stop being the reference's"))
        for f in flags:
            if f in _FAST_MATH:
                out.append(Violation(
                    RULE, src.rel, node.lineno,
                    f"fmad-false: NVCC_FLAGS carries {f} — fast math "
                    f"flushes subnormals / contracts products; the kernels' "
                    f"bytes depend on neither happening"))
        return out
    return [Violation(RULE, src.rel, 0,
                      "fmad-false: no NVCC_FLAGS tuple in _build.py — the "
                      "build flags cannot be checked")]


def _explicit_fma(ctx: Context, code: Dict[str, str]) -> List[Violation]:
    out = []
    for rel, text in code.items():
        spans = call_spans(text, "__fmaf_rn")
        for i, left, right in products(text):
            rate = [w for w in left[-1:] + right[:1] if w in _RATES]
            if not rate:
                continue
            other = right if left[-1:] == rate[:1] else left
            if not [w for w in other if w not in _RATES]:
                continue   # a rate times a constant (the decay)
            if _inside(spans, i):
                continue
            out.append(Violation(
                RULE, rel, _line_of(text, i),
                f"explicit-fma: `{rate[0]} * ...` outside __fmaf_rn — an "
                f"update the reference rounds once (c + r*lap, fused) is "
                f"rounded twice here under -fmad=false; write "
                f"__fmaf_rn({rate[0]}, lap, c)"))
        if rel.endswith(LANE_SOURCES) and not re.search(
                r"__fmaf_rn\s*\(\s*(r|r_l)\s*,", text):
            out.append(Violation(
                RULE, rel, 1,
                "explicit-fma: no fused lane update __fmaf_rn(r, lap, c) in "
                "a lane kernel source — the lane update must round once"))
    return out


def _policy_blocks(text: str) -> List[Tuple[int, int]]:
    return blocks(text, r"\bstruct\s+" + POLICY + r"\b")


def _select_not_mask(ctx: Context, code: Dict[str, str]) -> List[Violation]:
    out = []
    for rel, text in code.items():
        if rel.endswith(LANES_COMMON):
            scopes = [(0, len(text))]
        elif rel.endswith(LANE_SOURCES):
            scopes = _policy_blocks(text)
        else:
            continue
        for i, left, right in products(text):
            if not _inside([(a - 1, b) for a, b in scopes], i):
                continue
            masks = [w for w in left + right if _MASK_RE.match(w)]
            if masks:
                out.append(Violation(
                    RULE, rel, _line_of(text, i),
                    f"select-not-mask: `{masks[0]}` multiplies a value — "
                    f"a lane keeps a cell by a select (live ? u : c, or "
                    f"the masks' bitwise select), never by a "
                    f"multiply-mask, which does not keep a NaN/Inf cell's "
                    f"bytes as the reference's where does"))
    return out


def _method(text: str, start: int, end: int, name: str
            ) -> Optional[Tuple[int, int]]:
    """The brace block of method ``name`` inside ``[start, end)``."""
    for o, c in blocks(text[start:end], r"\b" + name + r"\s*\("):
        return start + o, start + c
    return None


def _storage_round(ctx: Context, code: Dict[str, str]) -> List[Violation]:
    out = []
    for rel, text in code.items():
        if rel.endswith(LANES_COMMON):
            m = re.search(r"to_storage\s*<\s*__nv_bfloat16\s*>\s*\(", text)
            if m is not None:
                o = text.find("{", m.end())
                seg = text[o:_match(text, o, "{", "}")] if o > 0 else ""
                if "__float2bfloat16_rn" not in seg:
                    out.append(Violation(
                        RULE, rel, _line_of(text, m.start()),
                        "storage-round: to_storage<__nv_bfloat16> does not "
                        "round with __float2bfloat16_rn (round to nearest "
                        "even, torch's conversion)"))
            continue
        if not rel.endswith(LANE_SOURCES):
            continue
        policies = _policy_blocks(text)
        for a, b in policies:
            keep = _method(text, a, b, "keep")
            if keep is None or not any(
                    s in text[keep[0]:keep[1]] for s in _STORAGE_ROUNDS):
                out.append(Violation(
                    RULE, rel, _line_of(text, a),
                    f"storage-round: {POLICY}'s keep() does not round its "
                    f"updates to the storage type — a lane rounds every "
                    f"step, as the reference's lane program does"))
        wrapped = call_spans(text, "to_storage")
        for m in re.finditer(r"__fmaf_rn\s*\(\s*(r|r_l)\s*,", text):
            if _inside(policies, m.start()) or _inside(wrapped, m.start()):
                continue
            out.append(Violation(
                RULE, rel, _line_of(text, m.start()),
                "storage-round: a lane update outside a lane policy is not "
                "wrapped in to_storage<T>(...) — the lane kernels round to "
                "the storage type every step"))
    return out


def _pyproject(ctx: Context) -> Optional[Path]:
    p = ctx.root.parent / "pyproject.toml"
    return p if p.is_file() else None


def _cuh_shipped(ctx: Context) -> List[Violation]:
    import tomllib

    out = []
    files = [s.rel for s in ctx.csources if s.rel.startswith(CSRC)]
    pp = _pyproject(ctx)
    if pp is not None and files:
        try:
            data = tomllib.loads(pp.read_text())
        except (OSError, ValueError) as e:
            return [Violation(RULE, "../pyproject.toml", 0,
                              f"cuh-shipped: cannot read pyproject.toml "
                              f"({e})")]
        pkg_data = (data.get("tool", {}).get("setuptools", {})
                    .get("package-data", {}))
        pats = pkg_data.get(f"{ctx.root.name}.ops", [])
        for rel in files:
            inner = rel[len("ops/"):]
            if not any(fnmatch.fnmatch(inner, p) for p in pats):
                out.append(Violation(
                    RULE, "../pyproject.toml", 0,
                    f"cuh-shipped: {rel} is not in pyproject.toml's "
                    f"package data for {ctx.root.name}.ops ({pats}) — an "
                    f"installed package could not build its kernels"))
    src = ctx.source(BUILD)
    headers = [r for r in files if r.endswith(".cuh")]
    if src is None or not headers:
        return out
    globbed: List[str] = []
    line = 0
    for fn in src.functions():
        if fn.name != "build":
            continue
        line = fn.lineno
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and attr_chain(node.func)[-1:] == ["glob"]
                    and node.args and isinstance(node.args[0], ast.Constant)):
                globbed.append(node.args[0].value)
    for rel in headers:
        name = rel.rsplit("/", 1)[-1]
        if not any(fnmatch.fnmatch(name, p) for p in globbed):
            out.append(Violation(
                RULE, src.rel, line,
                f"cuh-shipped: {rel} is not part of _build.build's library "
                f"hash (globs {globbed}) — a changed header would reuse a "
                f"stale library"))
    return out


def stripped_sources(ctx: Context) -> Dict[str, str]:
    """Comment-stripped text of every CUDA source under ``ops/csrc``."""
    return {s.rel: strip_comments(s.text) for s in ctx.csources
            if s.rel.startswith(CSRC)}


@register(RULE,
          "CUDA source disciplines: -fmad=false, explicit __fmaf_rn "
          "updates, select not multiply-mask in the lane policies, "
          "storage rounding every lane step, every header shipped and "
          "hashed")
def check(ctx: Context) -> List[Violation]:
    code = stripped_sources(ctx)
    return (_fmad_false(ctx) + _explicit_fma(ctx, code)
            + _select_not_mask(ctx, code) + _storage_round(ctx, code)
            + _cuh_shipped(ctx))
