"""Expression engine — FFmpeg's av_expr language, complete; a
numpy-free copy of `gmat_tpu/filters/expr.py` (the port keeps its own
so that it never imports the JAX package; `tests/test_torch_graph.py`
holds the two equal).

Rebuilds the expression language of `libavutil/eval.c` (the engine behind
select_cuda expressions, vf_select_cuda.c:53-100 var_names; doc usage
`select_cuda='gt(scene,0.4)'`, FrameSelect.h:12). Full function set per
eval.c:156-167,426-476: comparison/math/rounding, lazy if/ifnot, stateful
st/ld/random (a 10-slot register file persisting across evaluations of the
same compiled expression, eval.c:56 VARS), while, taylor, root, bitand/bitor,
gcd, hypot/atan2, hyperbolics, lerp, squish/gauss, isnan/isinf, print/time;
operators + - * / ^ and `;` sequencing; av_strtod numeric suffixes incl. dB
(eval.c:106-137) and hex literals.

Semantics follow C: out-of-domain math yields nan/inf, never raises
(pow(0,-1)=inf, exp(1000)=inf, log(-1)=nan); the untaken branch of
if/ifnot/while is never evaluated; `while` is unbounded exactly like
eval.c:239-243 (an expression `while(1,1)` spins — same as ffmpeg).

Recursive-descent parser -> AST of Python closures; evaluation is per-frame
on host scalars (the heavy part — scene scores — is computed on device in
batches by the port's ops/scene.py).
"""
from __future__ import annotations

import logging
import math
import re
import time as _time
from typing import Callable, Dict, List

Num = float
Env = Dict[str, float]

_LOG = logging.getLogger("gmat_tpu_torch.expr")

# numbers: hex, or decimals with optional exponent, then an optional
# av_strtod postfix: dB (decibels, checked FIRST like eval.c:116), an SI
# prefix (k/M/G/..., 'i' = binary), trailing 'B' = bytes -> x8
_TOKEN = re.compile(
    r"\s*(?:(0[xX][0-9a-fA-F]+|(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)"
    r"(dB|[yzafpnumcdhkKMGTPEZY]i?B?|B)?(?![0-9A-Za-z_.])"
    r"|([A-Za-z_]\w*)|(.))")

# eval.c:69-104 si_prefixes: decimal value 10^exp; binary ('i') value
# 2^(exp*10/3) — defined for EVERY prefix (1mi == 2^-10), not just k..Y
_SUFFIX_EXP = {"y": -24, "z": -21, "a": -18, "f": -15, "p": -12,
               "n": -9, "u": -6, "m": -3, "c": -2, "d": -1,
               "h": 2, "k": 3, "K": 3, "M": 6, "G": 9, "T": 12,
               "P": 15, "E": 18, "Z": 21, "Y": 24}
_SUFFIX = {c: 10.0 ** e for c, e in _SUFFIX_EXP.items()}
_SUFFIX_I = {c: 2.0 ** (e * 10.0 / 3.0) for c, e in _SUFFIX_EXP.items()}

_NAN = float("nan")
_INF = float("inf")
_VARS = 10                       # eval.c:56 #define VARS 10
_MASK64 = (1 << 64) - 1


def _while_cap() -> int:
    """0 (default) = unbounded, exactly like eval.c (while(1,1) spins).
    Set GMAT_EXPR_WHILE_CAP=N to make runaway loops raise ValueError —
    for harnesses evaluating untrusted expressions (the fuzz marathon)."""
    import os
    try:
        return int(os.environ.get("GMAT_EXPR_WHILE_CAP", "0"))
    except ValueError:
        return 0


def _apply_suffix(value: float, suf: str) -> float:
    """av_strtod postfix semantics (eval.c:114-137)."""
    if not suf:
        return value
    if suf == "dB":
        return 10.0 ** (value / 20.0)
    mult = 1.0
    if suf.endswith("B"):
        suf = suf[:-1]
        mult = 8.0
    if suf.endswith("i"):
        mult *= _SUFFIX_I[suf[0]]
    elif suf:
        mult *= _SUFFIX[suf]
    return value * mult


_STRTOD_RE = re.compile(
    r"(0[xX][0-9a-fA-F]+|[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)"
    r"(dB|[yzafpnumcdhkKMGTPEZY]i?B?|B)?")


def av_strtod(text: str, pos: int = 0):
    """Standalone av_strtod (eval.c:106-143): returns (value, newpos).
    On parse failure returns (0.0, pos) — the tail stays put, exactly
    like strtod, so callers reproduce the C's one-char skip loops
    (e.g. af_amix parse_weights)."""
    ws = pos
    while ws < len(text) and text[ws].isspace():   # strtod skips space
        ws += 1
    m = _STRTOD_RE.match(text, ws)
    if not m:
        return 0.0, pos
    body, suf = m.group(1), m.group(2) or ""
    if body[:2].lower() == "0x":
        base = float(min(int(body, 16), _MASK64))
    else:
        base = float(body)
    return _apply_suffix(base, suf), m.end()


def _number_token(body: str, suf: str):
    """Token for a numeric literal. dB literals stay raw (pre-10^(x/20))
    so the parser can apply a leading '-' INSIDE the dB conversion, the
    way eval.c's parse_dB does (-3dB == 10^(-3/20), not -(3dB))."""
    if body[:2].lower() == "0x":
        # strtoul semantics: saturate at UINT64_MAX instead of growing an
        # unbounded Python int (float() of which can raise OverflowError)
        base = float(min(int(body, 16), _MASK64))
    else:
        base = float(body)
    if suf == "dB":
        return ("numdB", base)
    return ("num", _apply_suffix(base, suf or ""))


def _div(a: float, b: float) -> float:
    # av_expr: d2 ? d/d2 : d*INFINITY (eval.c:320) — no exception, and
    # 0/0 becomes nan exactly like C
    return a / b if b else a * _INF


def _mod(a: float, b: float) -> float:
    # av_expr mod is floor-mod with the divisor's sign (eval.c:309:
    # d - floor(d/d2)*d2); mod(x, 0) is nan like C
    if b == 0 or math.isnan(a) or math.isnan(b) or math.isinf(a):
        return _NAN
    if math.isinf(b):
        return a if (a >= 0) == (b > 0) else _NAN
    return a - math.floor(a / b) * b


def _pow(a: float, b: float) -> float:
    """C pow(): nan for negative base ^ non-integer, signed inf for
    0^negative / overflow — never raises (unlike math.pow)."""
    try:
        return math.pow(a, b)
    except OverflowError:
        neg = a < 0 and math.isfinite(b) and b == int(b) and int(b) % 2
        return -_INF if neg else _INF
    except ValueError:
        if a == 0.0 and b < 0:     # C pow(+-0, y<0) = +-inf (odd int y)
            neg = (math.copysign(1.0, a) < 0 and math.isfinite(b)
                   and b == int(b) and int(b) % 2)
            return -_INF if neg else _INF
        return _NAN


def _exp(a: float) -> float:
    try:
        return math.exp(a)
    except OverflowError:
        return _INF


def _sinh(a: float) -> float:
    try:
        return math.sinh(a)
    except OverflowError:
        return math.copysign(_INF, a)


def _cosh(a: float) -> float:
    try:
        return math.cosh(a)
    except OverflowError:
        return _INF


def _squish(a: float) -> float:
    # eval.c:192: 1/(1+exp(4*x)); exp overflow -> inf -> 0
    return 1.0 / (1.0 + _exp(4.0 * a))


def _domain(f):
    """C math never raises: out-of-domain becomes nan (asin(2), ...)."""
    def g(*a):
        try:
            return f(*a)
        except (ValueError, OverflowError, ZeroDivisionError):
            return _NAN
    return g


def _c_int64(d: float) -> int:
    """C (long int)double on x86-64: truncate toward zero; nan/inf and
    out-of-range saturate to INT64_MIN (cvttsd2si behavior)."""
    if math.isnan(d) or math.isinf(d) or not -2.0**63 <= d < 2.0**63:
        return -(1 << 63)
    return int(d)


def _bitop(a: float, b: float, op) -> float:
    # eval.c:326-327: nan-in nan-out, else (long)&/(long)| on int64
    if math.isnan(a) or math.isnan(b):
        return _NAN
    r = op(_c_int64(a) & _MASK64, _c_int64(b) & _MASK64) & _MASK64
    return float(r - (1 << 64) if r >= (1 << 63) else r)


def _gcd(a: float, b: float) -> float:
    # av_gcd (mathematics.c:37): gcd(0,b)=b, gcd(a,0)=a (sign kept),
    # otherwise positive gcd of |a|,|b| on int64
    ia, ib = _c_int64(a), _c_int64(b)
    if ia == 0:
        return float(ib)
    if ib == 0:
        return float(ia)
    return float(math.gcd(abs(ia), abs(ib)))


def _bitrev8(i: int) -> int:
    """ff_reverse[i]: bit-reversed byte (used by root(), eval.c:269)."""
    i &= 0xFF
    i = ((i & 0x55) << 1) | ((i >> 1) & 0x55)
    i = ((i & 0x33) << 2) | ((i >> 2) & 0x33)
    return ((i & 0x0F) << 4) | (i >> 4)


def _var_index(x: float) -> int:
    # av_clip((int)x, 0, VARS-1); nan -> slot 0
    if math.isnan(x):
        return 0
    return min(max(_c_int64(x), 0), _VARS - 1)


_FUNCS = {
    "gt": lambda a, b: 1.0 if a > b else 0.0,
    "gte": lambda a, b: 1.0 if a >= b else 0.0,
    "lt": lambda a, b: 1.0 if a < b else 0.0,
    "lte": lambda a, b: 1.0 if a <= b else 0.0,
    "eq": lambda a, b: 1.0 if a == b else 0.0,
    "ne": lambda a, b: 1.0 if a != b else 0.0,   # extension (not in eval.c)
    "not": lambda a: 1.0 if a == 0 else 0.0,
    # NOTE: if/ifnot/and/or/while/taylor/root and the stateful st/ld/random
    # are special forms handled in _parse_atom (lazy branches / var access)
    # eval.c ternaries, NOT Python min/max: max(2,nan) -> nan (2>nan is
    # false so d2 wins), max(nan,2) -> 2 — order-dependent like C
    "min": lambda a, b: a if a < b else b,
    "max": lambda a, b: a if a > b else b,
    "abs": abs,
    # C floor/ceil/round pass nan/inf through; math.floor raises — wrap
    "floor": lambda a: a if math.isnan(a) or math.isinf(a) \
        else float(math.floor(a)),
    "ceil": lambda a: a if math.isnan(a) or math.isinf(a) \
        else float(math.ceil(a)),
    # av_expr round is C round(): half AWAY from zero, not banker's
    "round": lambda a: a if math.isnan(a) or math.isinf(a) \
        else float(math.floor(a + 0.5) if a >= 0 else math.ceil(a - 0.5)),
    "mod": _mod,
    "between": lambda x, lo, hi: 1.0 if lo <= x <= hi else 0.0,
    "isnan": lambda a: 1.0 if math.isnan(a) else 0.0,
    "isinf": lambda a: 1.0 if math.isinf(a) else 0.0,
    # av_expr math set (animated overlay positions etc.)
    # C sin(inf) sets EDOM but RETURNS nan; math.sin(inf) raises — wrap
    "sin": _domain(math.sin),
    "cos": _domain(math.cos),
    "tan": _domain(math.tan),
    "atan": math.atan,
    "atan2": math.atan2,
    "asin": _domain(math.asin),
    "acos": _domain(math.acos),
    "sinh": _sinh,
    "cosh": _cosh,
    "tanh": math.tanh,
    "exp": _exp,
    "log": lambda a: math.log(a) if a > 0 else (-_INF if a == 0 else _NAN),
    "sqrt": lambda a: math.sqrt(a) if a >= 0 else _NAN,
    "pow": _pow,
    "trunc": lambda a: a if math.isnan(a) or math.isinf(a) \
        else float(math.trunc(a)),
    "sgn": lambda a: (a > 0) - (a < 0),
    "clip": lambda x, lo, hi: _NAN if (math.isnan(lo) or math.isnan(hi)
                                       or math.isnan(x) or lo > hi)
        else min(max(x, lo), hi),
    "hypot": math.hypot,
    "gauss": lambda x: _exp(-x * x / 2.0) / math.sqrt(2.0 * math.pi),
    "squish": _squish,
    "lerp": lambda v0, v1, f: v0 + (v1 - v0) * f,
    "bitand": lambda a, b: _bitop(a, b, int.__and__),
    "bitor": lambda a, b: _bitop(a, b, int.__or__),
    "gcd": _gcd,
    "time": lambda: _time.time(),
}

# (min_args, max_args); validated at parse like eval.c's verify_expr
_ARITY = {
    "gt": (2, 2), "gte": (2, 2), "lt": (2, 2), "lte": (2, 2), "eq": (2, 2),
    "ne": (2, 2), "not": (1, 1), "min": (2, 2), "max": (2, 2),
    "abs": (1, 1), "floor": (1, 1), "ceil": (1, 1), "round": (1, 1),
    "trunc": (1, 1), "sqrt": (1, 1), "sgn": (1, 1), "mod": (2, 2),
    "between": (3, 3), "clip": (3, 3), "isnan": (1, 1), "isinf": (1, 1),
    "sin": (1, 1), "cos": (1, 1), "tan": (1, 1), "atan": (1, 1),
    "asin": (1, 1), "acos": (1, 1), "sinh": (1, 1), "cosh": (1, 1),
    "tanh": (1, 1), "exp": (1, 1), "log": (1, 1), "pow": (2, 2),
    "hypot": (2, 2), "atan2": (2, 2), "gauss": (1, 1), "squish": (1, 1),
    "lerp": (3, 3), "bitand": (2, 2), "bitor": (2, 2), "gcd": (2, 2),
    "time": (0, 0),
    # special forms
    "if": (2, 3), "ifnot": (2, 3), "and": (2, 2), "or": (2, 2),
    "st": (2, 2), "ld": (1, 1), "random": (1, 1), "while": (2, 2),
    "taylor": (2, 3), "root": (2, 2), "print": (1, 2),
}

_SPECIAL = {"if", "ifnot", "and", "or", "st", "ld", "random", "while",
            "taylor", "root", "print"}

# av_expr named constants (eval-time fallback: env vars shadow them);
# QP2LAMBDA = FF_QP2LAMBDA (eval.c constants[] table)
_CONSTS = {"PI": math.pi, "E": math.e, "PHI": (1.0 + math.sqrt(5.0)) / 2.0,
           "QP2LAMBDA": 118.0}


class Expr:
    """A compiled expression. Carries a 10-slot register file (`st`/`ld`/
    `random`/`taylor`/`root` state) that persists across calls, exactly
    like AVExpr->var persists across av_expr_eval invocations."""

    def __init__(self, text: str, funcs=None):
        """funcs: optional caller-supplied functions (av_expr's funcs1/
        funcs2 analog, eval.c:477-489) — {name: (min_args, max_args,
        fn(env, *evaluated_args))}. Builtins are matched FIRST, exactly
        like parse_primary's strmatch chain precedes the funcs1 scan."""
        self.text = text
        self.var: List[float] = [0.0] * _VARS
        self._funcs = dict(funcs) if funcs else {}
        self._tokens = self._tokenize(text)
        self._pos = 0
        self._ast = self._parse_expr()
        if self._pos < len(self._tokens):
            raise ValueError(f"trailing input in expr {text!r} at "
                             f"{self._tokens[self._pos]}")

    @staticmethod
    def _tokenize(text):
        out = []
        pos = 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if m is None:  # a number glued to an identifier char: "1.2.3"
                raise ValueError(f"bad token in expr {text!r} at {pos}")
            pos = m.end()
            num, suf, name, sym = m.groups()
            if num is not None:
                out.append(_number_token(num, suf))
            elif name is not None:
                out.append(("name", name))
            elif sym and not sym.isspace():
                out.append(("sym", sym))
        return out

    def _peek(self, ahead=0):
        i = self._pos + ahead
        return self._tokens[i] if i < len(self._tokens) else (None, None)

    def _next(self):
        t = self._peek()
        self._pos += 1
        return t

    def _expect(self, sym):
        k, v = self._next()
        if k != "sym" or v != sym:
            raise ValueError(f"expected {sym!r} in {self.text!r}, got {v!r}")

    # grammar (precedence low->high, matching eval.c parse_expr..parse_pow):
    #   expr    := add (';' add)*          -- e_last: value of the last
    #   add     := mul (('+'|'-') mul)*
    #   mul     := factor (('*'|'/') factor)*
    #   factor  := ['+'|'-'] atom ('^' ['+'|'-'] atom)*   -- sign binds the
    #              whole power chain: -2^2 == -4 (eval.c parse_factor)
    #   atom    := number | name | name '(' args ')' | '(' expr ')'
    def _parse_expr(self):
        node = self._parse_add()
        while self._peek() == ("sym", ";"):
            self._next()
            rhs = self._parse_add()
            node = (lambda l, r: lambda env: (l(env), r(env))[1])(node, rhs)
        return node

    def _parse_add(self):
        node = self._parse_mul()
        while self._peek() == ("sym", "+") or self._peek() == ("sym", "-"):
            _, op = self._next()
            rhs = self._parse_mul()
            node = (lambda l, r, o=op: (lambda env: l(env) + r(env) if o == "+"
                                        else l(env) - r(env)))(node, rhs)
        return node

    def _parse_mul(self):
        node = self._parse_factor()
        while self._peek() in (("sym", "*"), ("sym", "/")):
            _, op = self._next()
            rhs = self._parse_factor()
            node = (lambda l, r, o=op: (lambda env: l(env) * r(env) if o == "*"
                                        else _div(l(env), r(env))))(node, rhs)
        return node

    def _neg_db_literal(self):
        """If the next tokens are `-<dB literal>`, consume them and return
        a closure for 10^(-x/20) — eval.c parse_dB keeps the sign INSIDE
        the conversion (-3dB == 10^(-3/20), not -(3dB)). Else None."""
        if self._peek() == ("sym", "-") and self._peek(1)[0] == "numdB":
            self._next()
            _, raw = self._next()
            v = 10.0 ** (-raw / 20.0)
            return lambda env, v=v: v
        return None

    def _signed_atom(self):
        """One optional sign, then an atom — eval.c parse_pow/parse_dB."""
        sign = 1
        if self._peek() in (("sym", "-"), ("sym", "+")):
            node = self._neg_db_literal()
            if node is not None:
                return node
            _, s = self._next()
            sign = -1 if s == "-" else 1
        node = self._parse_atom()
        if sign < 0:
            return (lambda n: lambda env: -n(env))(node)
        return node

    def _parse_factor(self):
        # eval.c parse_factor: the leading sign applies to the WHOLE power
        # chain (-2^2 == -4); each exponent may carry its own sign (2^-1)
        sign = 1
        node = None
        if self._peek() in (("sym", "-"), ("sym", "+")):
            node = self._neg_db_literal()
            if node is None:
                _, s = self._next()
                sign = -1 if s == "-" else 1
        if node is None:
            node = self._parse_atom()
        while self._peek() == ("sym", "^"):
            self._next()
            rhs = self._signed_atom()
            node = (lambda l, r: lambda env: _pow(l(env), r(env)))(node, rhs)
        if sign < 0:
            return (lambda n: lambda env: -n(env))(node)
        return node

    def _parse_atom(self):
        kind, val = self._next()
        if kind == "num":
            return lambda env, v=val: v
        if kind == "numdB":
            v = 10.0 ** (val / 20.0)
            return lambda env, v=v: v
        if kind == "name":
            if self._peek() == ("sym", "("):
                self._next()
                args = []
                if self._peek() != ("sym", ")"):
                    args.append(self._parse_expr())
                    while self._peek() == ("sym", ","):
                        self._next()
                        args.append(self._parse_expr())
                self._expect(")")
                if val not in _ARITY:
                    if val in self._funcs:     # caller funcs AFTER builtins
                        lo, hi, cf = self._funcs[val]
                        if not lo <= len(args) <= hi:
                            raise ValueError(
                                f"{val}() takes {lo}-{hi} args, got "
                                f"{len(args)} in {self.text!r}")
                        return lambda env, cf=cf, args=args: \
                            float(cf(env, *[a(env) for a in args]))
                    raise ValueError(f"unknown function {val!r} in {self.text!r}")
                lo, hi = _ARITY[val]
                if not lo <= len(args) <= hi:
                    raise ValueError(f"{val}() takes {lo}-{hi} args, got "
                                     f"{len(args)} in {self.text!r}")
                if val in _SPECIAL:
                    return self._special_form(val, args)
                f = _FUNCS[val]
                return lambda env, f=f, args=args: float(f(*[a(env) for a in args]))
            name = val

            def var(env, n=name, text=self.text):
                if n in env:
                    return float(env[n])
                if n in _CONSTS:
                    return _CONSTS[n]
                raise ValueError(f"unknown variable {n!r} in expression "
                                 f"{text!r}")
            return var
        if kind == "sym" and val == "(":
            node = self._parse_expr()
            self._expect(")")
            return node
        raise ValueError(f"unexpected token {val!r} in {self.text!r}")

    def _special_form(self, name, args):
        """Lazy / stateful forms. Branch laziness matches av_expr e_if
        (the untaken branch never runs, so `if(gt(t,0), 1/t, 0)` is safe
        at t==0); st/ld/random/taylor/root share self.var, persisting
        across __call__s of this compiled expression (eval.c var[VARS])."""
        var = self.var

        if name in ("if", "ifnot"):
            c, a = args[0], args[1]
            b = args[2] if len(args) == 3 else None
            inv = name == "ifnot"

            def f_if(env, c=c, a=a, b=b, inv=inv):
                taken = (c(env) == 0) if inv else (c(env) != 0)
                if taken:
                    return float(a(env))
                return float(b(env)) if b is not None else 0.0
            return f_if

        if name in ("and", "or"):
            l, r = args
            if name == "and":
                return lambda env: 1.0 if (l(env) != 0 and r(env) != 0) else 0.0
            return lambda env: 1.0 if (l(env) != 0 or r(env) != 0) else 0.0

        if name == "st":        # eval.c:323 — store, returns the value
            i, v = args

            def f_st(env, i=i, v=v):
                d2 = v(env)
                var[_var_index(i(env))] = d2
                return d2
            return f_st

        if name == "ld":        # eval.c:194
            (i,) = args
            return lambda env, i=i: var[_var_index(i(env))]

        if name == "random":    # eval.c:232-238 — LCG seeded from var[idx]
            (i,) = args

            def f_random(env, i=i):
                idx = _var_index(i(env))
                v = var[idx]
                if math.isnan(v):
                    r = 0                    # eval.c:234 nan seed -> 0
                elif math.isinf(v):
                    r = 1 << 63              # C u64 cast of inf: x86 pattern
                else:
                    r = int(v) & _MASK64
                r = (r * 1664525 + 1013904223) & _MASK64
                var[idx] = float(r)
                return r * (1.0 / _MASK64)
            return f_random

        if name == "while":     # eval.c:239-243 — nan if the loop never ran
            c, body = args

            def f_while(env, c=c, body=body):
                d = _NAN
                cap = _while_cap()
                if cap <= 0:
                    while c(env):        # nan is truthy in C too
                        d = body(env)
                    return d
                n = 0
                while c(env):
                    d = body(env)
                    n += 1
                    if n >= cap:
                        raise ValueError(
                            f"while() exceeded GMAT_EXPR_WHILE_CAP={cap}")
                return d
            return f_while

        if name == "taylor":    # eval.c:245-262
            e0, e1 = args[0], args[1]
            e2 = args[2] if len(args) == 3 else None

            def f_taylor(env, e0=e0, e1=e1, e2=e2):
                x = e1(env)
                idx = _var_index(e2(env)) if e2 is not None else 0
                var0 = var[idx]
                t, d = 1.0, 0.0
                for i in range(1000):
                    prev = d
                    var[idx] = float(i)
                    v = e0(env)
                    d += t * v
                    if prev == d and v:
                        break
                    t *= x / (i + 1)
                var[idx] = var0
                return d
            return f_taylor

        if name == "root":      # eval.c:263-300 — bisection over var[0]
            e0, e1 = args
            dbl_max = 1.7976931348623157e308

            def f_root(env, e0=e0, e1=e1):
                low = high = -1.0
                low_v, high_v = -dbl_max, dbl_max
                var0 = var[0]
                x_max = e1(env)
                for i in range(-1, 1024):
                    if i < 255:
                        var[0] = _bitrev8(i & 255) * x_max / 255.0
                    else:
                        v0 = x_max * 0.9 ** (i - 255)
                        if i & 1:
                            v0 = -v0
                        v0 += low if (i & 2) else high
                        var[0] = v0
                    v = e0(env)
                    if v <= 0 and v > low_v:
                        low, low_v = var[0], v
                    if v >= 0 and v < high_v:
                        high, high_v = var[0], v
                    if low >= 0 and high >= 0:
                        for _ in range(1000):
                            var[0] = (low + high) * 0.5
                            if low == var[0] or high == var[0]:
                                break
                            v = e0(env)
                            if v <= 0:
                                low = var[0]
                            if v >= 0:
                                high = var[0]
                            if math.isnan(v):
                                low = high = v
                                break
                        break
                var[0] = var0
                return low if -low_v < high_v else high
            return f_root

        if name == "print":     # eval.c:226-231 — log and pass through
            e0 = args[0]
            e1 = args[1] if len(args) == 2 else None

            def f_print(env, e0=e0, e1=e1):
                x = e0(env)
                av_level = 32.0 if e1 is None else e1(env)  # AV_LOG_INFO
                # AV_LOG_* -> logging: ERROR<=16, WARNING=24, INFO=32,
                # VERBOSE/DEBUG>=40 (the level expr RUNS — side effects
                # included, like eval.c's av_clip(eval_expr(...)))
                if math.isnan(av_level) or av_level >= 40:
                    lvl = logging.DEBUG
                elif av_level >= 32:
                    lvl = logging.INFO
                elif av_level >= 24:
                    lvl = logging.WARNING
                else:
                    lvl = logging.ERROR
                _LOG.log(lvl, "%f", x)
                return x
            return f_print

        raise AssertionError(name)

    def __call__(self, env: Env) -> float:
        return self._ast(env)


def compile_expr(text: str, funcs=None) -> Callable[[Env], float]:
    return Expr(text, funcs=funcs)
