"""RPL004 cuda-smem-budget: a block's shared memory, bounded statically.

The counterpart of the JAX package's ``pallas-vmem-budget``.  There a
Pallas kernel's working set must fit a TPU core's ~16 MiB of VMEM; on
Hopper the scarce on-chip store is a block's shared memory, 227 KiB
(232,448 B) at most, and only 48 KiB of it without the opt-in.  A
kernel that launches at test shapes can be refused at production ones
(a launch over the limit never runs, and only ``cudaGetLastError``
says so), so this rule reads every ``.cu`` / ``.cuh`` kernel source
under ``repro_torch/kernels/csrc`` and checks, for each ``__global__``
function:

(a) **Static shared memory.**  The sum of its ``__shared__``
    declarations that are not ``extern``, and of those in the
    ``__device__`` helpers it calls (followed transitively, each helper
    once), must stay within ``static_limit_bytes`` (48 KiB).  Array
    sizes are integer constant expressions over the file's
    namespace-scope ``constexpr`` integers (those of its quoted
    ``#include`` headers too), the kernel's own ``constexpr`` locals
    and ``options["bindings"]``, the values each template parameter is
    instantiated with: a template kernel is evaluated under every
    combination of the parameters its sizes name.  Element sizes come
    from :data:`TYPE_BYTES` through the file's ``typedef`` / ``using``
    aliases.  A symbol or type the estimator cannot resolve is itself a
    finding naming it — the estimator refuses to guess.

(b) **Dynamic shared memory is opted in and bounded.**  A kernel that
    declares ``extern __shared__`` must be named by a
    ``cudaFuncSetAttribute(<kernel>, cudaFuncAttributeMaxDynamicShared
    MemorySize, ...)`` in the same file (directly, through a local it
    was assigned to, or through a parameter of the launching function
    that a call in the file passes it to).  Its bytes must be bounded:
    by a ``static_assert(<bytes> <= <limit>)`` whose left side names
    shared-memory bytes (an identifier matching ``smem``, ``bytes`` or
    ``shared``) and whose limit evaluates to at most ``budget_bytes``,
    or by a host-side check against the device's opt-in maximum
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``) whose ``if`` returns
    before the launch.  As the JAX package's divisibility check looks
    for the ``assert`` and not its arithmetic, this checks that the
    guard is there, not the C++ arithmetic that feeds it.

The JAX package's third check, the **masked tail**, has no static
counterpart over C++: a kernel computes its own offsets from
``blockIdx`` and masks the ragged edge in code no pattern can bound.
Its counterpart is ``chip_smoke.py``'s comparison of every kernel with
its plain version at ragged shapes on the card.

:func:`estimate_static_smem` and :class:`CudaUnit` are import-stable
API: ``chip_smoke.py`` holds (a)'s bytes against ptxas's report.
"""
from __future__ import annotations

import bisect
import itertools
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.base import Finding, Rule

#: bytes of an element of each type a ``__shared__`` array may hold
TYPE_BYTES: Dict[str, int] = {
    "char": 1, "signed char": 1, "unsigned char": 1, "bool": 1,
    "int8_t": 1, "uint8_t": 1,
    "short": 2, "unsigned short": 2, "int16_t": 2, "uint16_t": 2,
    "half": 2, "__half": 2, "__nv_bfloat16": 2,
    "int": 4, "unsigned": 4, "unsigned int": 4, "float": 4,
    "int32_t": 4, "uint32_t": 4, "half2": 4, "__half2": 4,
    "__nv_bfloat162": 4,
    "long": 8, "unsigned long": 8, "long long": 8,
    "unsigned long long": 8, "int64_t": 8, "uint64_t": 8, "size_t": 8,
    "double": 8, "float2": 8, "int2": 8, "uint2": 8,
    "float4": 16, "int4": 16, "uint4": 16, "double2": 16,
}
_QUALIFIERS = {"const", "volatile", "static", "struct", "__restrict__"}
_SMEM_NAME = re.compile(r"smem|bytes|shared", re.I)
_OPTIN_ATTR = "cudaDevAttrMaxSharedMemoryPerBlockOptin"
_DYN_ATTR = "cudaFuncAttributeMaxDynamicSharedMemorySize"


class UnboundSymbol(Exception):
    """A size names a symbol (or an element type) with no value."""

    def __init__(self, symbol: str):
        super().__init__(symbol)
        self.symbol = symbol


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

_STRIP_RE = re.compile(
    r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\\n])*\"|'(?:\\.|[^'\\\n])*'", re.S)
_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<str>"(?:\\.|[^"\\\n])*"|'(?:\\.|[^'\\\n])*')
  | (?P<num>0[xX][0-9A-Fa-f']+[uUlL]*|\.?\d[\w'.]*)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op>::|->|<<|>>|<=|>=|==|!=|&&|\|\||\S)
""", re.X)
_INCLUDE_RE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


@dataclass(frozen=True)
class Tok:
    kind: str        # "id", "num", "str" or "op"
    text: str
    pos: int         # offset in the source


def _blank(m: re.Match) -> str:
    s = m.group(0)
    if s[0] in "\"'":
        return s
    return re.sub(r"[^\n]", " ", s)


def tokenize(source: str) -> List[Tok]:
    """C++ tokens of ``source`` with comments and preprocessor lines
    dropped; offsets index the original text."""
    text = _STRIP_RE.sub(_blank, source)
    # preprocessor lines (and their continuations) carry no declaration
    text = re.sub(r"^[ \t]*#(?:[^\n]*\\\n)*[^\n]*",
                  lambda m: re.sub(r"[^\n]", " ", m.group(0)), text,
                  flags=re.M)
    out = []
    for m in _TOKEN_RE.finditer(text):
        if m.lastgroup != "ws":
            out.append(Tok(m.lastgroup, m.group(0), m.start()))
    return out


def _close(toks: Sequence[Tok], i: int) -> int:
    """Index of the bracket closing the one at ``toks[i]``."""
    pairs = {"(": ")", "[": "]", "{": "}"}
    opener, closer, depth = toks[i].text, pairs[toks[i].text], 0
    for j in range(i, len(toks)):
        if toks[j].text == opener:
            depth += 1
        elif toks[j].text == closer:
            depth -= 1
            if depth == 0:
                return j
    raise UnboundSymbol(f"unbalanced `{opener}`")


def _close_angle(toks: Sequence[Tok], i: int) -> int:
    """Index of the ``>`` closing the ``<`` at ``toks[i]`` (``>>``
    closes two)."""
    depth = 0
    for j in range(i, len(toks)):
        t = toks[j].text
        if t == "<":
            depth += 1
        elif t in (">", ">>"):
            depth -= len(t)
            if depth <= 0:
                return j
        elif t in (";", "{", "}"):
            break
    raise UnboundSymbol("unbalanced `<`")


def _split_top(toks: Sequence[Tok], sep: str) -> List[List[Tok]]:
    """``toks`` cut at each ``sep`` outside brackets."""
    parts: List[List[Tok]] = [[]]
    depth = 0
    for t in toks:
        if t.text in "([{":
            depth += 1
        elif t.text in ")]}":
            depth -= 1
        if t.text == sep and depth == 0:
            parts.append([])
        else:
            parts[-1].append(t)
    return parts


# ---------------------------------------------------------------------------
# integer constant expressions
# ---------------------------------------------------------------------------

_BINARY = {
    "||": 1, "&&": 2, "|": 3, "^": 4, "&": 5, "==": 6, "!=": 6,
    "<": 7, ">": 7, "<=": 7, ">=": 7, "<<": 8, ">>": 8,
    "+": 9, "-": 9, "*": 10, "/": 10, "%": 10,
}


def _cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _apply(op: str, a: int, b: int) -> int:
    if op in ("/", "%") and b == 0:
        raise UnboundSymbol("division by zero")
    return {
        "||": lambda: int(bool(a) or bool(b)),
        "&&": lambda: int(bool(a) and bool(b)),
        "|": lambda: a | b, "^": lambda: a ^ b, "&": lambda: a & b,
        "==": lambda: int(a == b), "!=": lambda: int(a != b),
        "<": lambda: int(a < b), ">": lambda: int(a > b),
        "<=": lambda: int(a <= b), ">=": lambda: int(a >= b),
        "<<": lambda: a << b, ">>": lambda: a >> b,
        "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
        "/": lambda: _cdiv(a, b), "%": lambda: a - b * _cdiv(a, b),
    }[op]()


class _Expr:
    """A precedence-climbing evaluator over one expression's tokens;
    ``lookup(name)`` gives a name's value or raises UnboundSymbol."""

    def __init__(self, toks: Sequence[Tok], lookup, sizeof):
        self.toks, self.i = list(toks), 0
        self.lookup, self.sizeof = lookup, sizeof

    def peek(self) -> str:
        return self.toks[self.i].text if self.i < len(self.toks) else ""

    def take(self, want: Optional[str] = None) -> Tok:
        if self.i >= len(self.toks) or (want and self.peek() != want):
            raise UnboundSymbol(
                " ".join(t.text for t in self.toks) or "<empty>")
        self.i += 1
        return self.toks[self.i - 1]

    def run(self) -> int:
        v = self.ternary()
        if self.i != len(self.toks):
            raise UnboundSymbol(" ".join(t.text for t in self.toks))
        return v

    def ternary(self) -> int:
        cond = self.binary(1)
        if self.peek() != "?":
            return cond
        self.take("?")
        a = self.ternary()
        self.take(":")
        b = self.ternary()
        return a if cond else b

    def binary(self, floor: int) -> int:
        v = self.unary()
        while _BINARY.get(self.peek(), 0) >= floor:
            op = self.take().text
            v = _apply(op, v, self.binary(_BINARY[op] + 1))
        return v

    def unary(self) -> int:
        t = self.peek()
        if t in ("-", "+", "!", "~"):
            self.take()
            v = self.unary()
            return {"-": -v, "+": v, "!": int(not v), "~": ~v}[t]
        return self.primary()

    def primary(self) -> int:
        t = self.take()
        if t.kind == "num":
            text = t.text.replace("'", "").rstrip("uUlL")
            try:
                return int(text, 0)
            except ValueError:
                raise UnboundSymbol(t.text) from None
        if t.text in ("true", "false"):
            return int(t.text == "true")
        if t.text == "(":
            v = self.ternary()
            self.take(")")
            return v
        if t.text == "sizeof":
            self.take("(")
            words = []
            while self.peek() not in (")", ""):
                words.append(self.take().text)
            self.take(")")
            return self.sizeof(words)
        if t.kind == "id":
            if self.peek() in ("::", "("):
                raise UnboundSymbol(self._qualified(t.text))
            return self.lookup(t.text)
        raise UnboundSymbol(t.text)

    def _qualified(self, head: str) -> str:
        # name the whole `S::kBytes` / `f(x)` the size depends on
        words, depth = [head], 0
        while self.i < len(self.toks):
            t = self.toks[self.i].text
            if t in ("<", "(", "["):
                depth += 1
            elif t in (">", ")", "]"):
                depth -= 1
            elif depth == 0 and t != "::" and words[-1] != "::":
                break
            words.append(t)
            self.i += 1
        return "".join(words)


# ---------------------------------------------------------------------------
# the source's structure
# ---------------------------------------------------------------------------


@dataclass
class SharedDecl:
    """One ``__shared__`` declarator."""

    name: str
    type_words: List[str]
    dims: List[List[Tok]]          # one token list per `[...]`
    extern: bool
    align: int                     # __align__(n), else 0
    pointer: bool = False


@dataclass
class Function:
    """One function definition at namespace or struct scope."""

    name: str
    line: int
    col: int
    is_global: bool
    template_params: List[str]     # value and type parameters, in order
    params: List[str]              # names of the function's parameters
    body: Tuple[int, int]          # indices in `toks` of `{` and `}`
    toks: List[Tok] = field(default_factory=list, repr=False)
    shared: List[SharedDecl] = field(default_factory=list)
    locals: Dict[str, List[Tok]] = field(default_factory=dict)


def _top_words(toks: Sequence[Tok]) -> List[str]:
    """The texts of ``toks`` outside parentheses."""
    out, depth = [], 0
    for t in toks:
        depth += {"(": 1, ")": -1}.get(t.text, 0)
        if depth == 0:
            out.append(t.text)
    return out


def _template_params(head: Sequence[Tok]) -> List[str]:
    if not head or head[0].text != "template":
        return []
    end = _close_angle(head, 1)
    out = []
    for part in _split_top(head[2:end], ","):
        part = _split_top(part, "=")[0]
        names = [t.text for t in part if t.kind == "id"]
        if len(names) >= 2:
            out.append(names[-1])
    return out


def _decl_name(seg: Sequence[Tok]) -> Tuple[int, bool]:
    """Index of a declarator's name in ``seg`` and whether it is a
    pointer."""
    stop = len(seg)
    for j, t in enumerate(seg):
        if t.text in ("[", "="):
            stop = j
            break
    for j in range(stop - 1, -1, -1):
        if seg[j].kind == "id":
            return j, any(t.text == "*" for t in seg[:j])
    raise UnboundSymbol(" ".join(t.text for t in seg) or "<declarator>")


def _parse_shared(toks: Sequence[Tok], at: int, start: int,
                  end: int, align_of) -> List[SharedDecl]:
    """The declarators of the ``__shared__`` statement whose keyword is
    ``toks[at]`` (statement from ``start`` to the ``;`` at ``end``)."""
    extern = any(t.text == "extern" for t in toks[start:at])
    rest = list(toks[at + 1:end])
    align, j = 0, 0
    while j < len(rest):
        t = rest[j].text
        if t in ("__align__", "alignas") and j + 1 < len(rest):
            k = _close(rest, j + 1)
            align = align_of(rest[j + 2:k])
            j = k + 1
        elif t in _QUALIFIERS:
            j += 1
        else:
            break
    rest = rest[j:]
    out = []
    base: List[str] = []
    for n, seg in enumerate(_split_top(rest, ",")):
        idx, ptr = _decl_name(seg)
        if n == 0:
            base = [t.text for t in seg[:idx]
                    if t.text not in _QUALIFIERS and t.text != "*"]
        dims, k = [], idx + 1
        while k < len(seg) and seg[k].text == "[":
            c = _close(seg, k)
            dims.append(list(seg[k + 1:c]))
            k = c + 1
        out.append(SharedDecl(seg[idx].text, base, dims, extern, align,
                              pointer=ptr))
    return out


class CudaUnit:
    """One CUDA source parsed for RPL004: its functions (kernels and
    helpers), namespace-scope ``constexpr`` integers and type aliases
    (its quoted ``#include`` headers' too), ``static_assert``s, opt-in
    calls and host checks against the opt-in maximum."""

    def __init__(self, source: str, path: str = "<cuda>",
                 _seen: Optional[Set[str]] = None):
        self.path, self.source = path, source
        self.toks = tokenize(source)
        self._nl = [m.start() for m in re.finditer("\n", source)]
        self.consts: Dict[str, List[Tok]] = {}
        self.aliases: Dict[str, List[str]] = {}
        self.functions: Dict[str, List[Function]] = {}
        self.kernels: List[Function] = []
        self._const_cache: Dict[str, int] = {}
        self._evaluating: Set[str] = set()
        seen = set(_seen or ()) | {str(Path(path).resolve())}
        for inc in _INCLUDE_RE.findall(source):
            p = Path(path).parent / inc
            if p.is_file() and str(p.resolve()) not in seen:
                hdr = CudaUnit(p.read_text(), str(p), seen)
                self.consts.update(hdr.consts)
                self.aliases.update(hdr.aliases)
                for name, fns in hdr.functions.items():
                    self.functions.setdefault(name, []).extend(fns)
        self._scan()
        self.extern_align = max(
            [self._align(d) for fns in self.functions.values() for f in fns
             for d in f.shared if d.extern] or [0])

    # -- helpers ----------------------------------------------------------

    def line_col(self, pos: int) -> Tuple[int, int]:
        n = bisect.bisect_left(self._nl, pos)      # newlines before pos
        return n + 1, pos - (self._nl[n - 1] + 1 if n else 0)

    def _declaration(self, stmt: Sequence[Tok]) -> None:
        """Record a namespace-scope constexpr integer or type alias."""
        words = [t.text for t in stmt]
        if not words or words[0] == "template" or "{" in words:
            return
        if words[0] == "typedef" and "(" not in words and len(words) > 2:
            self.aliases[words[-1]] = words[1:-1]
        elif words[0] == "using" and len(words) > 3 and words[2] == "=":
            self.aliases[words[1]] = words[3:]
        elif ("constexpr" in words or "const" in words) and "=" in words:
            eq = words.index("=")
            if "(" in words[:eq] or words[eq - 1] == "]" \
                    or stmt[eq - 1].kind != "id":
                return
            self.consts[words[eq - 1]] = list(stmt[eq + 1:])

    def _function(self, head: Sequence[Tok], lb: int, rb: int) -> None:
        close = len(head) - 1
        while head[close].text != ")":
            close -= 1
        depth, open_ = 0, close
        for open_ in range(close, -1, -1):
            depth += {")": 1, "(": -1}.get(head[open_].text, 0)
            if depth == 0:
                break
        k = open_ - 1
        if k >= 0 and head[k].text in (">", ">>"):
            depth = 0
            while k >= 0:
                depth += {">": 1, ">>": 2, "<": -1}.get(head[k].text, 0)
                k -= 1
                if depth <= 0:
                    break
        if k < 0 or head[k].kind != "id":
            return
        params = [next((t.text for t in reversed(_split_top(p, "=")[0])
                        if t.kind == "id"), "")
                  for p in _split_top(head[open_ + 1:close], ",")]
        is_global = any(t.text == "__global__" for t in head)
        anchor = next((t for t in head if t.text == "__global__"), head[k])
        line, col = self.line_col(anchor.pos)
        fn = Function(head[k].text, line, col, is_global,
                      _template_params(head), params, (lb, rb), self.toks)
        self._body(fn)
        self.functions.setdefault(fn.name, []).append(fn)
        if is_global:
            self.kernels.append(fn)

    def _body(self, fn: Function) -> None:
        lb, rb = fn.body
        toks = self.toks
        start = lb + 1
        for i in range(lb + 1, rb):
            t = toks[i].text
            if t in (";", "{", "}"):
                start = i + 1
            elif t == "__shared__":
                end = i
                while toks[end].text != ";":
                    end += 1
                fn.shared.extend(_parse_shared(
                    toks, i, start, end, self.eval))
            elif t == "constexpr":
                end = i
                while toks[end].text not in (";", "{"):
                    end += 1
                words = [x.text for x in toks[i:end]]
                if "=" in words and "(" not in words[:words.index("=")]:
                    eq = i + words.index("=")
                    fn.locals.setdefault(toks[eq - 1].text,
                                         list(toks[eq + 1:end]))

    def _scan(self) -> None:
        """One pass over the braces: ``ns`` (namespace, ``extern "C"``),
        ``struct``, ``func`` bodies, and ``block`` braces (inside a
        function, or an initializer's) whose insides are left to
        :meth:`_body`."""
        toks = self.toks
        frames: List[List] = [["ns", 0, None]]   # kind, stmt start, extra
        for i, t in enumerate(toks):
            kind, start = frames[-1][0], frames[-1][1]
            if t.text == ";":
                if kind in ("ns", "struct"):
                    if kind == "ns":
                        self._declaration(toks[start:i])
                    frames[-1][1] = i + 1
            elif t.text == "{":
                head = toks[start:i]
                words = [x.text for x in head]
                if kind not in ("ns", "struct"):
                    frames.append(["block", i + 1, None])
                elif "namespace" in words[:2] or words == ["extern", '"C"']:
                    frames.append(["ns", i + 1, None])
                else:
                    last = len(words) - 1
                    while last >= 0 and words[last] in (
                            "const", "noexcept", "override", "final"):
                        last -= 1
                    if last >= 0 and words[last] == ")" \
                            and "=" not in _top_words(head):
                        frames.append(["func", i + 1, (head, i)])
                    elif {"struct", "class", "union", "enum"} & set(words):
                        frames.append(["struct", i + 1, None])
                    else:                      # an initializer's braces
                        frames.append(["block", i + 1, None])
            elif t.text == "}" and len(frames) > 1:
                kind, _, extra = frames.pop()
                if kind == "func":
                    self._function(extra[0], extra[1], i)
                if kind in ("func", "ns"):
                    frames[-1][1] = i + 1

    # -- evaluation -------------------------------------------------------

    def const(self, name: str) -> int:
        """The value of a namespace-scope constexpr integer."""
        if name in self._const_cache:
            return self._const_cache[name]
        if name not in self.consts or name in self._evaluating:
            raise UnboundSymbol(name)
        self._evaluating.add(name)
        try:
            v = self.eval(self.consts[name])
        finally:
            self._evaluating.discard(name)
        self._const_cache[name] = v
        return v

    def eval(self, toks: Sequence[Tok],
             env: Optional[Dict[str, int]] = None,
             local: Optional[Dict[str, List[Tok]]] = None) -> int:
        """An integer constant expression under ``env`` (template
        bindings), then ``local`` constexprs, then the file's."""
        env = env or {}
        local = local or {}
        busy: Set[str] = set()

        def lookup(name: str) -> int:
            if name in env:
                return int(env[name])
            if name in local and name not in busy:
                busy.add(name)
                try:
                    return _Expr(local[name], lookup, self.sizeof).run()
                finally:
                    busy.discard(name)
            return self.const(name)

        return _Expr(toks, lookup, self.sizeof).run()

    def resolve_type(self, words: Sequence[str]) -> str:
        words = [w for w in words if w not in _QUALIFIERS]
        for _ in range(8):
            if len(words) == 1 and words[0] in self.aliases:
                words = [w for w in self.aliases[words[0]]
                         if w not in _QUALIFIERS]
        return " ".join(words)

    def sizeof(self, words: Sequence[str]) -> int:
        if any(w == "*" for w in words):
            return 8
        name = self.resolve_type(words)
        if name not in TYPE_BYTES:
            raise UnboundSymbol(name or "<type>")
        return TYPE_BYTES[name]

    def _align(self, d: SharedDecl) -> int:
        return d.align or min(16, self.sizeof(d.type_words))

    def decl_bytes(self, d: SharedDecl, env: Dict[str, int],
                   local: Dict[str, List[Tok]]) -> int:
        n = 8 if d.pointer else self.sizeof(d.type_words)
        for dim in d.dims:
            n *= self.eval(dim, env, local)
        return n

    def helpers(self, fn: Function) -> List[Function]:
        """The functions of this unit ``fn`` calls, transitively, each
        once (overloads and instantiations of one name all count)."""
        seen: Dict[int, Function] = {}
        todo = [fn]
        while todo:
            f = todo.pop()
            lb, rb = f.body
            for i in range(lb + 1, rb):
                t = f.toks[i]
                if t.kind != "id" or t.text not in self.functions:
                    continue
                nxt = f.toks[i + 1].text
                if nxt == "<":
                    try:
                        nxt = f.toks[_close_angle(f.toks, i + 1) + 1].text
                    except UnboundSymbol:
                        continue
                if nxt != "(":
                    continue
                for g in self.functions[t.text]:
                    if id(g) not in seen and g is not fn:
                        seen[id(g)] = g
                        todo.append(g)
        return [g for g in seen.values() if not g.is_global]

    def static_decls(self, fn: Function) -> List[Tuple[Function,
                                                      SharedDecl]]:
        """(owner, declaration) of every non-extern ``__shared__`` a
        launch of ``fn`` reserves: its own and its helpers'."""
        return [(f, d) for f in [fn] + self.helpers(fn)
                for d in f.shared if not d.extern]

    def static_smem(self, fn: Function, env: Dict[str, int]) -> int:
        """Static shared bytes of one instantiation of kernel ``fn``
        (``env``: its template parameters' values).  Raises
        :class:`UnboundSymbol`."""
        total = 0
        for owner, d in self.static_decls(fn):
            local = owner.locals
            total += self.decl_bytes(d, env if owner is fn else {}, local)
        return total

    # -- (b): opt-in and bound --------------------------------------------

    def _calls(self, name: str) -> Iterator[Tuple[int, int]]:
        """(open, close) token indices of each call ``name(...)`` /
        ``name<...>(...)`` in the unit."""
        toks = self.toks
        for i, t in enumerate(toks[:-1]):
            if t.text != name:
                continue
            j = i + 1
            if toks[j].text == "<":
                try:
                    j = _close_angle(toks, j) + 1
                except UnboundSymbol:
                    continue
            if j < len(toks) and toks[j].text == "(":
                yield j, _close(toks, j)

    def _enclosing(self, i: int) -> Optional[Function]:
        """The function of this file (not of a header) around token i."""
        for fns in self.functions.values():
            for f in fns:
                if f.toks is self.toks and f.body[0] < i < f.body[1]:
                    return f
        return None

    def opted_in(self) -> Set[str]:
        """Kernels named by a ``cudaFuncSetAttribute(...,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` here."""
        kernels = {k.name for k in self.kernels}
        out: Set[str] = set()
        for lo, hi in self._calls("cudaFuncSetAttribute"):
            args = self.toks[lo + 1:hi]
            texts = [t.text for t in args]
            if _DYN_ATTR not in texts:
                continue
            first = [t.text for t in args[:texts.index(_DYN_ATTR)]
                     if t.kind == "id"]
            out |= kernels & set(first)
            fn = self._enclosing(lo)
            if fn is None:
                continue
            for name in set(first) - kernels:
                out |= self._assigned_kernels(fn, name, kernels)
                if name in fn.params:
                    for clo, chi in self._calls(fn.name):
                        if not fn.body[0] < clo < fn.body[1]:
                            out |= kernels & {t.text for t in
                                              self.toks[clo + 1:chi]}
        return out

    def _assigned_kernels(self, fn: Function, name: str,
                          kernels: Set[str]) -> Set[str]:
        out: Set[str] = set()
        lb, rb = fn.body
        for i in range(lb + 1, rb - 1):
            if self.toks[i].text == name and self.toks[i + 1].text == "=":
                j = i + 2
                while j < rb and self.toks[j].text != ";":
                    if self.toks[j].text in kernels:
                        out.add(self.toks[j].text)
                    j += 1
        return out

    def smem_asserts(self, budget: int) -> Tuple[List[int], List[int]]:
        """Limits of the ``static_assert(<smem bytes> <= <limit>)``
        clauses: (those within ``budget``, those over it)."""
        ok, over = [], []
        for lo, hi in self._calls("static_assert"):
            args = self.toks[lo + 1:hi]
            # drop the message: the last top-level `, "..."`
            for j in range(len(args) - 1, -1, -1):
                if args[j].text == "," and j + 1 < len(args) \
                        and args[j + 1].kind == "str":
                    args = args[:j]
                    break
            for clause in _split_top(args, "&&"):
                ops = [j for j, t in enumerate(clause)
                       if t.text in ("<=", ">=")]
                if len(ops) != 1:
                    continue
                j = ops[0]
                lhs, rhs = clause[:j], clause[j + 1:]
                if clause[j].text == ">=":
                    lhs, rhs = rhs, lhs
                if not any(t.kind == "id" and _SMEM_NAME.search(t.text)
                           for t in lhs):
                    continue
                try:
                    limit = self.eval(rhs)
                except UnboundSymbol:
                    continue
                (ok if limit <= budget else over).append(limit)
        return ok, over

    def optin_checks(self) -> int:
        """How many ``if`` conditions compare a value with the device's
        opt-in maximum (read through ``cudaDeviceGetAttribute(&v,
        cudaDevAttrMaxSharedMemoryPerBlockOptin, ...)``) and return."""
        toks = self.toks
        names = set()
        for lo, hi in self._calls("cudaDeviceGetAttribute"):
            args = [t.text for t in toks[lo + 1:hi]]
            if _OPTIN_ATTR in args and len(args) > 1 and args[0] == "&":
                names.add(args[1])
        n = 0
        for lo, hi in self._calls("if"):
            cond = {t.text for t in toks[lo + 1:hi]}
            if not (cond & names and cond & {"<", ">", "<=", ">="}):
                continue
            after = [t.text for t in toks[hi + 1:hi + 3]]
            if after[:1] == ["return"] or after == ["{", "return"]:
                n += 1
        return n


def estimate_static_smem(path, bindings: Dict[str, int]) -> Dict[str, int]:
    """Static shared bytes of each ``__global__`` function in the CUDA
    source at ``path``, its template parameters bound by ``bindings``
    (one value each).  Raises :class:`UnboundSymbol` naming a symbol or
    type no binding, constexpr or table resolves."""
    unit = CudaUnit(Path(path).read_text(), str(path))
    out: Dict[str, int] = {}
    for k in unit.kernels:
        out[k.name] = max(out.get(k.name, 0),
                          unit.static_smem(k, dict(bindings)))
    return out


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


def _instantiations(unit: CudaUnit, k: Function,
                    bindings: Dict[str, Sequence[int]]
                    ) -> Iterator[Tuple[Dict[str, int], int]]:
    """(env, static bytes) of ``k`` under each combination of the
    bindings of the template parameters its sizes name.  Raises
    :class:`UnboundSymbol` for a parameter with no binding."""
    needed: List[str] = []
    while True:
        env = {p: _values(bindings[p])[0] for p in needed}
        try:
            unit.static_smem(k, env)
            break
        except UnboundSymbol as exc:
            sym = exc.symbol
            if sym in k.template_params and sym in bindings \
                    and sym not in needed:
                needed.append(sym)
                continue
            raise
    for combo in itertools.product(*(_values(bindings[p])
                                     for p in needed)):
        env = dict(zip(needed, combo))
        yield env, unit.static_smem(k, env)


def _values(v) -> List[int]:
    return [int(x) for x in v] if isinstance(v, (list, tuple)) else [int(v)]


class CudaSmemRule(Rule):
    id = "RPL004"
    name = "cuda-smem-budget"
    summary = ("kernel's static shared memory over 48 KiB or unbound, or "
               "extern __shared__ without the opt-in or a bound")
    language = "cuda"

    def check(self, ctx) -> Iterator[Finding]:
        if "__global__" not in ctx.source:
            return
        budget = int(self.options.get("budget_bytes", 232448))
        limit = int(self.options.get("static_limit_bytes", 48 * 1024))
        bindings = dict(self.options.get("bindings", {}))
        try:
            unit = CudaUnit(ctx.source, ctx.path)
        except UnboundSymbol as exc:
            yield Finding(rule=self.id, path=ctx.path, line=0, col=0,
                          message=f"cannot parse this CUDA source: "
                                  f"{exc.symbol}")
            return
        dynamic = [k for k in unit.kernels
                   if any(d.extern for d in k.shared)]
        opted = unit.opted_in() if dynamic else set()
        ok, over = unit.smem_asserts(budget) if dynamic else ([], [])
        bounded = bool(ok) or unit.optin_checks() > 0
        for k in unit.kernels:
            yield from self._static(ctx, unit, k, bindings, limit)
            if k not in dynamic:
                continue
            if k.name not in opted:
                yield self._at(
                    ctx, k,
                    f"kernel `{k.name}` declares `extern __shared__` but "
                    f"no `cudaFuncSetAttribute({k.name}, "
                    f"cudaFuncAttributeMaxDynamicSharedMemorySize, ...)` "
                    f"in this file opts it in — a launch over "
                    f"{limit:,} B of dynamic shared memory is refused")
            if not bounded:
                why = (f" (the static_assert limit "
                       f"{max(over):,} B exceeds the {budget:,} B budget)"
                       if over else "")
                yield self._at(
                    ctx, k,
                    f"kernel `{k.name}`'s dynamic shared memory has no "
                    f"bound{why} — add `static_assert(<bytes> <= "
                    f"<limit>)` with a limit of at most {budget:,} B, or "
                    f"a host check against "
                    f"cudaDevAttrMaxSharedMemoryPerBlockOptin that "
                    f"returns an error before the launch")

    def _static(self, ctx, unit: CudaUnit, k: Function, bindings,
                limit: int) -> Iterator[Finding]:
        try:
            for env, n in _instantiations(unit, k, bindings):
                if n > limit:
                    at = ", ".join(f"{p}={v}" for p, v in env.items())
                    yield self._at(
                        ctx, k,
                        f"kernel `{k.name}`"
                        + (f" at {at}" if at else "")
                        + f" declares {n:,} B of static shared memory, "
                          f"over the {limit:,} B a block gets without "
                          f"the opt-in — make the arrays `extern "
                          f"__shared__` and opt in, or shrink them")
                    return
        except UnboundSymbol as exc:
            yield self._at(
                ctx, k,
                f"cannot bound the static shared memory of `{k.name}`: "
                f"`{exc.symbol}` has no value — add the template "
                f"parameter to the RPL004 `bindings` option (its deployed "
                f"values), or the constant / type to the source")

    def _at(self, ctx, k: Function, message: str) -> Finding:
        return Finding(rule=self.id, path=ctx.path, line=k.line,
                       col=k.col, message=message)
