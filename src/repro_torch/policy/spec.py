"""Declarative policy-spec grammar: ``name[key=value,key=value]``.

A scheduling policy is *data*: a registered name plus a dict of explicitly
overridden, typed parameters. The textual form round-trips —
``parse(str(spec)) == spec`` — so a spec survives CSV sweep rows, CLI flags,
and worker-process boundaries unchanged, and any sweep cell can be rebuilt
from its output row alone.

The grammar itself (syntax, type coercion, did-you-mean errors) lives in
``repro_torch.spec`` — it is shared with scenario specs and executor specs
(``repro_torch.experiments``). This module binds it to the *policy* registry:
``PolicySpec`` validates through ``repro_torch.policy.registry``, and the error
names below keep their established identities (``UnknownPolicyError`` is
still a ``KeyError`` for backward compatibility with the old
``make_scheduler`` lambda-table lookup).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.spec import (ParamValueError, Spec, SpecError, SpecSyntaxError,
                              UnknownNameError, UnknownParamError, format_value,
                              split_specs)
from repro_torch.spec import coerce_value as _coerce_value
from repro_torch.spec import parse_raw as _parse_raw

#: Backward-compatible aliases: every policy-spec error is a shared
#: ``repro_torch.spec`` error, so ``except PolicySpecError`` and
#: ``except UnknownPolicyError`` keep working across the extraction.
PolicySpecError = SpecError
UnknownPolicyError = UnknownNameError

__all__ = [
    "PolicySpec", "PolicySpecError", "SpecSyntaxError", "UnknownPolicyError",
    "UnknownParamError", "ParamValueError", "format_value", "coerce_value",
    "parse_raw", "split_specs",
]


@dataclasses.dataclass(frozen=True)
class PolicySpec(Spec):
    """A scheduler policy as data: registered name + explicit typed params.

    ``params`` holds only the *overridden* parameters — defaults stay with
    the registry entry, so ``str(spec)`` is terse and two specs compare equal
    exactly when they would build identically configured schedulers.
    """

    # -- functional updates (validated against the registry) -----------------

    def with_params(self, **overrides) -> "PolicySpec":
        """New spec with ``overrides`` replacing/adding params (validated —
        unknown or ill-typed keys raise, the silent-kwarg-drop fix)."""
        from repro_torch.policy import registry
        return registry.get_policy(self.name).make_spec(
            **{**self.params, **overrides})

    def with_defaults(self, **defaults) -> "PolicySpec":
        """New spec with ``defaults`` filled in only where not already set
        (setdefault semantics; validated like ``with_params``)."""
        from repro_torch.policy import registry
        return registry.get_policy(self.name).make_spec(
            **{**defaults, **self.params})


def coerce_value(raw: object, typ: type, *, policy: str, key: str) -> object:
    """Coerce ``raw`` to the declared param type (policy-flavoured wrapper
    over ``repro_torch.spec.coerce_value``)."""
    return _coerce_value(raw, typ, owner=f"policy {policy!r}", key=key)


def parse_raw(text: str) -> Tuple[str, Dict[str, str]]:
    """Syntax-level parse: ``text`` -> (name, raw string params).

    Validates the grammar only; the registry layer (``repro_torch.policy.parse``)
    types the values and checks the keys against the policy's schema.
    """
    return _parse_raw(text, kind="policy")
