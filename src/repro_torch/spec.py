"""Shared declarative-spec grammar: ``name[key=value,key=value]`` (the
port of ``repro/spec.py``; the port's registries are its own).

One grammar, many registries. A *spec* is data — a registered name plus a
dict of explicitly overridden, typed parameters — whose textual form
round-trips exactly (``parse(str(spec)) == spec``), so a spec survives CSV
rows, CLI flags, JSON plans, and worker-process boundaries unchanged.

Scheduling policies (``"waterwise[lam_h2o=0.7,backend=torch]"``),
*scenarios* (``"diurnal[days=10,jobs_per_day=1e6]"``) and *executors*
(``"process[max_workers=4]"``) speak the same language. Registries
(``repro_torch.policy.registry``, ``repro_torch.experiments.scenario``,
``repro_torch.experiments.executor``) supply the per-name parameter
schemas; this module owns the syntax, the type coercion, and the
did-you-mean error surface.

Grammar (whitespace around tokens is ignored)::

    spec    :=  name [ '[' params ']' ]
    name    :=  [A-Za-z0-9._-]+
    params  :=  kv ( ',' kv )*  |  <empty>
    kv      :=  key '=' value
    key     :=  [A-Za-z0-9_]+
    value   :=  any run of characters except ',' ']' '='

Values are typed against the registered schema, not guessed from their
spelling: ``backend=torch`` stays a string because ``backend`` is declared
``str``, ``lam_h2o=0.7`` becomes a float because ``lam_h2o`` is declared
``float``. Formatting uses ``repr`` for floats, so parse∘format is exact
(floats round-trip bit-for-bit through ``repr``/``float``).
"""
from __future__ import annotations

import dataclasses
import difflib
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


class SpecError(ValueError):
    """Base class for every spec-grammar / registry error."""


class SpecSyntaxError(SpecError):
    """Malformed spec string (bad brackets, missing '=', empty key...)."""


class UnknownNameError(SpecError, KeyError):
    """Spec names something that is not registered (KeyError for backward
    compatibility with plain dict-lookup call sites)."""

    def __str__(self) -> str:        # KeyError would repr() the message
        return self.args[0] if self.args else ""


class UnknownParamError(SpecError):
    """Spec carries a parameter the registered entry does not declare."""


class ParamValueError(SpecError):
    """Parameter value cannot be coerced to its declared type."""


_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")
_KEY_RE = re.compile(r"^[A-Za-z0-9_]+$")

#: Parameter types the grammar can express (and round-trip exactly).
SPEC_TYPES = (bool, int, float, str)


@dataclasses.dataclass(frozen=True)
class Spec:
    """A registered name + explicit typed params, as data.

    ``params`` holds only the *overridden* parameters — defaults stay with
    the registry entry, so ``str(spec)`` is terse and two specs compare
    equal exactly when they describe identically configured objects.
    Registries subclass this (``PolicySpec``, ``ScenarioSpec``) to attach
    their validation hooks; the textual form is shared.
    """

    name: str
    params: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", dict(self.params))

    def format(self) -> str:
        """Canonical string form (sorted params; omits brackets when empty)."""
        if not self.params:
            return self.name
        kv = ",".join(f"{k}={format_value(self.params[k])}"
                      for k in sorted(self.params))
        return f"{self.name}[{kv}]"

    def __str__(self) -> str:
        return self.format()


@dataclasses.dataclass(frozen=True)
class Param:
    """One typed, documented spec parameter (the default lives here purely
    as documentation — the builder's own signature stays the source of
    truth, and builders receive only explicitly overridden keys)."""
    name: str
    type: type
    default: object
    help: str = ""

    def describe(self) -> str:
        return (f"{self.name}={format_value(self.default)}"
                f":{self.type.__name__}")


def format_value(v: object) -> str:
    """Render one param value so that type-directed parsing recovers it."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)               # repr round-trips floats exactly
    return str(v)


def coerce_value(raw: object, typ: type, *, owner: str, key: str) -> object:
    """Coerce ``raw`` (a grammar string or an already-typed Python value) to
    the declared param type, raising ``ParamValueError`` on mismatch.

    ``owner`` names the registry entry for the error message, e.g.
    ``"policy 'waterwise'"`` or ``"scenario 'diurnal'"``.
    """

    def bad(expected: str):
        return ParamValueError(
            f"{owner}: parameter {key!r} expects {expected}, got {raw!r}")

    if typ is bool:
        if isinstance(raw, bool):
            return raw
        if isinstance(raw, (int, float)) and raw in (0, 1):
            return bool(raw)
        if isinstance(raw, str):
            low = raw.strip().lower()
            if low in ("true", "1", "yes", "on"):
                return True
            if low in ("false", "0", "no", "off"):
                return False
        raise bad("a bool (true/false)")
    if typ is int:
        if isinstance(raw, bool):
            raise bad("an int")
        if isinstance(raw, int):
            return raw
        if isinstance(raw, float) and raw == int(raw):
            return int(raw)
        if isinstance(raw, str):
            try:
                return int(raw.strip())
            except ValueError:
                raise bad("an int") from None
        raise bad("an int")
    if typ is float:
        if isinstance(raw, bool):
            raise bad("a float")
        if isinstance(raw, (int, float)):
            return float(raw)
        if isinstance(raw, str):
            try:
                return float(raw.strip())
            except ValueError:
                raise bad("a float") from None
        raise bad("a float")
    if typ is str:
        if isinstance(raw, str):
            return raw
        raise bad("a string")
    raise ParamValueError(f"{owner}: parameter {key!r} declares "
                          f"unsupported type {typ!r}")


def parse_raw(text: str, kind: str = "spec") -> Tuple[str, Dict[str, str]]:
    """Syntax-level parse: ``text`` -> (name, raw string params).

    Validates the grammar only; the registry layer types the values and
    checks the keys against the entry's schema. ``kind`` labels the error
    messages (``"policy"``, ``"scenario"``, ``"executor"``).
    """
    label = f"{kind} spec" if kind != "spec" else "spec"
    if not isinstance(text, str):
        raise SpecSyntaxError(f"{label} must be a string, got {text!r}")
    s = text.strip()
    if "[" not in s:
        name, body = s, None
    else:
        name, _, rest = s.partition("[")
        if not rest.endswith("]"):
            raise SpecSyntaxError(f"unterminated '[' in {label} {text!r}")
        body = rest[:-1]
        if "[" in body or "]" in body:
            raise SpecSyntaxError(f"nested brackets in {label} {text!r}")
    name = name.strip()
    if not _NAME_RE.match(name):
        raise SpecSyntaxError(f"invalid {kind} name in spec {text!r}")
    params: Dict[str, str] = {}
    if body is not None and body.strip():
        for item in body.split(","):
            key, eq, value = item.partition("=")
            key, value = key.strip(), value.strip()
            if not eq:
                raise SpecSyntaxError(
                    f"expected key=value, got {item.strip()!r} in {text!r}")
            if not _KEY_RE.match(key):
                raise SpecSyntaxError(f"invalid parameter key {key!r} "
                                      f"in {text!r}")
            if not value:
                raise SpecSyntaxError(f"empty value for parameter {key!r} "
                                      f"in {text!r}")
            if key in params:
                raise SpecSyntaxError(f"duplicate parameter {key!r} "
                                      f"in {text!r}")
            params[key] = value
    return name, params


def split_specs(text: str) -> List[str]:
    """Split a comma-separated list of spec strings, honouring brackets:
    ``"a,b[x=1,y=2],c"`` -> ``["a", "b[x=1,y=2]", "c"]`` (the CLI
    list grammar shared by ``--schedulers`` and ``--scenarios``)."""
    out: List[str] = []
    depth, cur = 0, []
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(depth - 1, 0)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [s.strip() for s in out if s.strip()]


# ---------------------------------------------------------------------------
# Registry-side helpers (shared did-you-mean surface)
# ---------------------------------------------------------------------------

def unknown_name_error(kind: str, name: str,
                       known: Sequence[str]) -> UnknownNameError:
    """``UnknownNameError`` with a did-you-mean hint against ``known``."""
    hint = difflib.get_close_matches(name, known, n=1)
    did = f" — did you mean {hint[0]!r}?" if hint else ""
    return UnknownNameError(
        f"unknown {kind} {name!r}{did} (have: {', '.join(sorted(known))})")


def unknown_param_error(kind: str, owner: str, key: str,
                        known: Sequence[str]) -> UnknownParamError:
    """``UnknownParamError`` with a did-you-mean hint against ``known``."""
    if not known:
        return UnknownParamError(
            f"{kind} {owner!r} accepts no parameters (got {key!r})")
    hint = difflib.get_close_matches(key, known, n=1)
    did = f" — did you mean {hint[0]!r}?" if hint else ""
    return UnknownParamError(
        f"unknown parameter {key!r} for {kind} {owner!r}{did} "
        f"(accepts: {', '.join(known)})")


def validate_params(kind: str, owner: str, schema: Mapping[str, Param],
                    raw: Mapping[str, object]) -> Dict[str, object]:
    """Type-check ``raw`` against ``schema``: unknown keys raise with a
    did-you-mean, values are coerced to their declared types. Returns the
    validated (typed) param dict — the one a ``Spec`` should carry."""
    out: Dict[str, object] = {}
    for key, value in raw.items():
        p = schema.get(key)
        if p is None:
            raise unknown_param_error(kind, owner, key, list(schema))
        out[key] = coerce_value(value, p.type,
                                owner=f"{kind} {owner!r}", key=key)
    return out


def params_from_signature(fn, *, skip: Sequence[str] = (),
                          drop_positional: int = 0,
                          help_text: Optional[Mapping[str, str]] = None
                          ) -> List[Param]:
    """Derive a ``Param`` list from a builder's signature.

    Takes every parameter with a default whose type is spec-expressible
    (``SPEC_TYPES``), skipping the first ``drop_positional`` positional
    arguments (e.g. a scenario builder's ``(days, seed, jobs_per_day,
    utilization)``) and anything in ``skip``. The signature stays the
    single source of truth — documented defaults can never drift from the
    code.
    """
    import inspect
    out: List[Param] = []
    helps = help_text or {}
    sig = inspect.signature(fn)
    for i, p in enumerate(sig.parameters.values()):
        if i < drop_positional or p.name in skip:
            continue
        if p.kind not in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                          inspect.Parameter.KEYWORD_ONLY):
            continue
        if p.default is inspect.Parameter.empty:
            continue
        if type(p.default) not in SPEC_TYPES:
            continue
        out.append(Param(p.name, type(p.default), p.default,
                         helps.get(p.name, "")))
    return out


def has_var_keyword(fn) -> bool:
    """True when ``fn`` forwards ``**kwargs`` (its schema should inherit
    the forwarding target's params)."""
    import inspect
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in inspect.signature(fn).parameters.values())
