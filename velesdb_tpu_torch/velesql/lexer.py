"""The contextual tokenizer shared by the VelesQL and MATCH parsers.

Both grammars are LALR(1) grammars whose keywords are also valid ``NAME``
tokens. Their parsers lex each token with the set of terminals that the
parser state accepts at that point, as a contextual lexer does: a word is a
keyword only where the state accepts that keyword, so ``SELECT limit FROM t``
reads ``limit`` as a name and ``WHERE x ISNULL`` reads ``IS`` then ``NULL``.

Within one state the terminals are tried in a fixed order (longest possible
match first, then the longer pattern, then the name); a word that ``NAME``
matches becomes the keyword of the same text when the state accepts that
keyword. Each parser names, after every token it consumes, the set of
terminals the state after that token accepts (LALR(1) states with one core
share their lookaheads, so these sets are unions over the contexts a token
can appear in).
"""

from __future__ import annotations

import re
from typing import NamedTuple

__all__ = ["Terminal", "Lexer", "TokenStream", "accepts", "keyword", "literal", "pattern",
           "END", "COMMON"]

END = "$END"
_UNBOUNDED = 1 << 64


class Terminal(NamedTuple):
    name: str
    regex: str
    value: str  # the literal (strings) or the regex source (patterns)
    is_string: bool
    ignorecase: bool
    max_width: int


def accepts(names: str) -> frozenset:
    """A state's accept set from space-separated terminal names."""
    return frozenset(names.split())


def keyword(name: str, text: str | None = None) -> Terminal:
    """A case-insensitive keyword, ``"SELECT"i`` in the grammar."""
    text = name if text is None else text
    return Terminal(name, f"(?i:{re.escape(text)})", text, True, True, len(text))


def literal(name: str, text: str) -> Terminal:
    """A case-sensitive literal such as ``"("`` or ``"-["``."""
    return Terminal(name, re.escape(text), text, True, False, len(text))


def pattern(name: str, regex: str, max_width: int = _UNBOUNDED) -> Terminal:
    return Terminal(name, regex, regex, False, False, max_width)


_INT = "(?:[0-9])+"
_SIGNED_NUMBER = (
    r"(?:(?:\+|\-))?(?:(?:(?:[0-9])+(?:e|E)(?:(?:\+|\-))?(?:[0-9])+|(?:(?:[0-9])+\.(?:(?:[0-9])+)?"
    r"|\.(?:[0-9])+)(?:(?:e|E)(?:(?:\+|\-))?(?:[0-9])+)?)|(?:[0-9])+)"
)

# the terminals both grammars define the same way
COMMON = {
    t.name: t
    for t in (
        pattern("NAME", r"[a-zA-Z_][a-zA-Z0-9_]*"),
        pattern("PARAM", r"\$[a-zA-Z_][a-zA-Z0-9_]*"),
        pattern("STRING", r"'([^']|'')*'"),
        pattern("SIGNED_NUMBER", _SIGNED_NUMBER),
        pattern("INT", _INT),
        pattern("CMP_OP", r"(?:==|!=|<>|>=|<=|=|>|<)", 2),
        pattern("PLUSMINUS", r"(?:\+|\-)", 1),
        literal("COMMA", ","),
        literal("DOT", "."),
        literal("LPAR", "("),
        literal("RPAR", ")"),
        literal("STAR", "*"),
    )
}
_WS = pattern("WS", r"(?:[ \t\x0c\r\n])+")


class _Scanner:
    """The compiled matcher of one accept set."""

    def __init__(self, terms: list[Terminal]):
        terms = sorted(terms + [_WS], key=lambda t: (-t.max_width, -len(t.value), t.name))
        strings = [t for t in terms if t.is_string]
        self.unless: dict[str, re.Pattern] = {}
        embedded = set()
        for r in terms:
            if r.is_string:
                continue
            hits = []
            for s in strings:
                m = re.match(r.regex, s.value)
                if m is not None and m.group(0) == s.value:
                    hits.append(s)
                    if not s.ignorecase:
                        embedded.add(s.name)
            if hits:
                self.unless[r.name] = re.compile(
                    "|".join(f"(?P<{s.name}>{s.regex})" for s in hits))
        self.rx = re.compile(
            "|".join(f"(?P<{t.name}>{t.regex})" for t in terms if t.name not in embedded))


class Lexer:
    """Contextual tokenizer over one grammar's terminals."""

    def __init__(self, terminals: dict[str, Terminal], error: type[Exception]):
        self._terminals = terminals
        self.error = error
        self._scanners: dict[frozenset, _Scanner] = {}

    def _scanner(self, accepts: frozenset) -> _Scanner:
        sc = self._scanners.get(accepts)
        if sc is None:
            sc = _Scanner([self._terminals[n] for n in accepts if n != END])
            self._scanners[accepts] = sc
        return sc

    def next(self, text: str, pos: int, accepts: frozenset) -> tuple[str, str, int]:
        """``(type, text, end)`` of the token at ``pos`` (whitespace skipped),
        ``(END, "", len(text))`` at the end of the input."""
        sc = self._scanner(accepts)
        while pos < len(text):
            m = sc.rx.match(text, pos)
            if m is None:
                raise self.error(f"unexpected character {text[pos]!r} at {pos}")
            kind, value = m.lastgroup, m.group(0)
            pos = m.end()
            if kind == "WS":
                continue
            sub = sc.unless.get(kind)
            if sub is not None:
                k = sub.fullmatch(value)
                if k is not None:
                    kind = k.lastgroup
            return kind, value, pos
        return END, "", pos


class TokenStream:
    """A parser's place in its text: the next token, lexed with the terminals
    that the state after the last consumed token accepts."""

    def __init__(self, lexer: Lexer, text: str, start: frozenset, grammar: str):
        self.lexer = lexer
        self.text = text
        self.pos = 0
        self.accepts = start
        self.tok: tuple[str, str, int] | None = None
        self.grammar = grammar

    def peek(self) -> str:
        if self.tok is None:
            self.tok = self.lexer.next(self.text, self.pos, self.accepts)
        return self.tok[0]

    def take(self, after: frozenset) -> str:
        """Consume the current token; ``after`` is what the next state accepts."""
        self.peek()
        _, value, self.pos = self.tok
        self.tok = None
        self.accepts = after
        return value

    def expect(self, kind: str, after: frozenset) -> str:
        if self.peek() != kind:
            raise self.fail()
        return self.take(after)

    def fail(self) -> Exception:
        self.peek()
        return self.lexer.error(f"{self.grammar} syntax error: unexpected {self.tok[0]} "
                                f"{self.tok[1]!r} at {self.pos}")
