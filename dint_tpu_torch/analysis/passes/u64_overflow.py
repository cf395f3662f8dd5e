"""u32-word pass: stamps, versions and log heads stay unsigned 32-bit.

The port carries every u32 word (lock stamps ``step << K | slot``, meta
``ver << 1 | exists``, SmallBank's step stamps, log heads, the store's
versions and arrival stamps) as the bit pattern of an ``int32`` (ops/
u32.py; ROADMAP "Facts" item 2). Equality and bitwise and/or are the
same on the bit patterns, but an ordered compare, an arithmetic right
shift or a division of the int32 pattern reads a word with its top bit
set as negative: every such op is wrong for half the word space (a
stamp's step field past 2^(31-K), a version past 2^30). That appears only
after thousands of steps — never in a smoke test, always in a long run.
The contract is to widen first: ``u32.to_u64`` (``to(int64) &
0xFFFFFFFF``), or ``u32.shr`` (an arithmetic shift whose result is masked
down to the field it keeps).

ERROR findings, on int32 operands whose def-chain reaches a word (a state
input named in `WORD_FIELDS`) with no range-limiting op in between:

  * ``signed-stamp-compare``: ``lt``/``le``/``gt``/``ge``/``maximum``/
    ``minimum``/``amax``/``amin``/``max``/``min``/``clamp``;
  * ``signed-word-shift``: ``__rshift__``/``bitwise_right_shift``, unless
    every user masks the result down to fewer than 31 bits (the
    `u32.shr` idiom);
  * ``signed-word-division``: ``remainder``/``div``/``floor_divide``/
    ``fmod``.

The chain follows magnitude only: it skips the index arguments of a
gather (``index``, ``index_select``, ``gather``, ``take``,
``take_along_dim``, a ``dint::`` gather's indices) and any boolean value
(a mask or a condition carries no magnitude), and it is CUT at
``bitwise_and`` (a masked widening, or a mask to a field), ``remainder``,
right shifts, divisions and ``minimum``/``clamp``: a value that went
through one of them no longer carries the word's magnitude, which is the
evidence that clears it.

The reference's ``i64-on-device`` warning has no twin: int64 is how the
port widens, on either device.
"""
from __future__ import annotations

import torch

from ..core import (Finding, SEV_ERROR, TargetTrace, flat_nodes,
                    node_inputs, op_name, register_pass, site_of, walk)

# the state inputs that hold u32 words, by the last part of their path
WORD_FIELDS = frozenset({"arb", "meta", "hot_meta", "vv1", "ws_vv",
                         "x_step", "s_step", "hot_x", "hot_s", "ver",
                         "d_ver", "d_seq", "d_seq_next"})
# ... and by the whole tail of it
WORD_PATHS = ("log.head",)

_CMP = frozenset({"lt", "le", "gt", "ge", "maximum", "minimum", "amax",
                  "amin", "max", "min", "clamp"})
_SHIFT = frozenset({"__rshift__", "bitwise_right_shift", "__irshift__"})
_DIV = frozenset({"remainder", "div", "floor_divide", "fmod"})
_RANGE_LIMITING = frozenset({"bitwise_and", "bitwise_and_", "__and__",
                             "remainder", "fmod", "__rshift__",
                             "bitwise_right_shift", "div", "floor_divide",
                             "minimum", "clamp", "clamp_max", "amin", "min"})


# the index arguments of the gathers, by op: no magnitude flows from them
_INDEX_ARGS = {"index": (1,), "index_select": (2,), "gather": (2,),
               "take": (1,), "take_along_dim": (1,),
               "dint::gather_rows": (1,), "dint::gather_streams": (1,),
               "dint::gather_rows_hot": (2, 3), "dint::scan_rows": (4,),
               "dint::lock_validate": (2, 4, 5, 6)}


# multi-output kernels: output k reads stream k of these arguments
_STREAMS = {"dint::gather_rows": (0,), "dint::gather_streams": (0,),
            "dint::gather_rows_hot": (0, 1)}


def is_word(path: str) -> bool:
    return (path.rsplit(".", 1)[-1] in WORD_FIELDS
            or any(path.endswith(p) for p in WORD_PATHS))


def _i32(arg) -> bool:
    v = arg.meta.get("val") if isinstance(arg, torch.fx.Node) else None
    return v is not None and getattr(v, "dtype", None) == torch.int32


def _is_bool(n) -> bool:
    v = n.meta.get("val")
    return v is not None and getattr(v, "dtype", None) == torch.bool


def _magnitude(graph, words) -> dict:
    """node -> True where its value's magnitude descends from a word (see
    the module docstring for the chain's rules)."""
    memo = graph.__dict__.setdefault("_dint_magnitude", {})
    key = frozenset(words)
    got = memo.get(key)
    if got is not None:
        return got
    got = memo[key] = {}
    for n in graph.nodes:
        hit = n in words
        name = op_name(n)
        if not hit and n.op == "call_function" and not _is_bool(n) \
                and name not in _RANGE_LIMITING:
            src = n.args[0] if n.args else None
            if name == "getitem" and isinstance(src, torch.fx.Node) and \
                    op_name(src) in _STREAMS:
                # one output of a multi-stream kernel: its own stream's
                # table (and mirror) only
                k = n.args[1]
                ins = [flat_nodes(src.args[a])[k]
                       for a in _STREAMS[op_name(src)]]
            elif name == "getitem" and isinstance(src, torch.fx.Node) and \
                    op_name(src) in ("dint::scan_rows",
                                     "dint::lock_validate"):
                # scan_rows' output k copies run array k; lock_validate's
                # rmeta reads meta
                k = n.args[1]
                ins = ([src.args[k]] if op_name(src) == "dint::scan_rows"
                       else [src.args[1]] if k == 2 else [])
            else:
                skip = _INDEX_ARGS.get(name, ())
                ins = [i for pos, a in enumerate(n.args) if pos not in skip
                       for i in flat_nodes(a)] if skip else node_inputs(n)
            hit = any(got.get(i, False) for i in ins)
        got[n] = hit
    return got


def _masked_down(node) -> bool:
    """Every user of a right shift masks it below bit 31 (u32.shr)."""
    users = list(node.users)
    if not users:
        return False
    for u in users:
        if op_name(u) not in ("bitwise_and", "__and__"):
            return False
        lits = [a for a in u.args if isinstance(a, int)]
        if not lits or not all(0 <= m < (1 << 31) for m in lits):
            return False
    return True


@register_pass("u64_overflow")
def u64_overflow(trace: TargetTrace) -> list[Finding]:
    """Flags signed compares, shifts and divisions of int32-carried u32
    words that were not widened first."""
    if trace.graph is None:
        return []
    words = {ph for ph, (path, st) in zip(
        (n for n in trace.graph.nodes if n.op == "placeholder"),
        trace.inputs) if st and is_word(path)}
    if not words:
        return []
    carries = _magnitude(trace.graph, words)
    out: list[Finding] = []
    for ctx in walk(trace):
        prim, node = ctx.prim, ctx.node
        if prim in _CMP:
            code, what = "signed-stamp-compare", "compare"
        elif prim in _SHIFT:
            if _masked_down(node):
                continue
            code, what = "signed-word-shift", "arithmetic right shift"
        elif prim in _DIV:
            code, what = "signed-word-division", "division"
        else:
            continue
        ops = [a for a in flat_nodes(node.args) if _i32(a)]
        if prim in _SHIFT or prim in _DIV:
            ops = ops[:1]
        for a in ops:
            if not carries.get(a, False):
                continue
            out.append(Finding(
                "u64_overflow", code, SEV_ERROR, trace.name,
                f"signed `{prim}` ({what}) on an int32-carried u32 word: "
                "a word with its top bit set reads as negative, so the "
                "result is wrong for half the word space",
                primitive=prim, site=site_of(node), path="/".join(ctx.path),
                suggestion="widen first (ops/u32.to_u64), or shift with "
                           "ops/u32.shr"))
            break
    return out
