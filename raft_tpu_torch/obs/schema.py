"""JSONL event-stream schema (counterpart of ``raft_tpu/obs/schema.py``):
the contract an exported stream is validated against.

Every line the :class:`raft_tpu_torch.obs.export.JsonlSink` writes is one
JSON object with a ``kind`` discriminator:

``kind="event"``
    ``name`` str, ``ts`` wall-clock float, ``t`` monotonic float,
    ``range`` str|null, ``range_stack`` list[str]; any further keys are
    free-form event attributes.
``kind="span"``
    ``name`` str, ``ts`` float, ``t`` monotonic float,
    ``duration`` float >= 0, ``parent`` str|null, ``thread`` int|null,
    ``attrs`` dict.
``kind="flight"``
    flight-recorder bundle header: ``error_type`` non-empty
    str, ``error`` str, ``ts``/``t`` numbers, ``n_spans``/``n_events``
    non-negative ints; ``op`` str|null.
``kind="metrics"``
    flight-bundle trailer: ``ts``/``t`` numbers, ``metrics`` dict (the
    registry snapshot).

Events, spans, and flight headers may additionally carry the bounded
trace-context triple ``trace_id``/``request_id``/``tenant`` — when
present each must be a non-empty string.

The validator is dependency-free (no jsonschema): it returns
human-readable problem strings instead of raising, so a check can
report every violation in one pass.
"""

from __future__ import annotations

import json
from typing import List, Tuple

__all__ = ["validate_record", "validate_jsonl",
           "validate_flight_bundle", "validate_chrome_trace"]

KINDS = ("event", "span", "flight", "metrics")

_CTX_FIELDS = ("trace_id", "request_id", "tenant")


def _check(problems, cond, msg):
    if not cond:
        problems.append(msg)


def validate_record(obj) -> List[str]:
    """Problems with one decoded JSONL record ([] when valid)."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"record is {type(obj).__name__}, not an object"]
    kind = obj.get("kind")
    if kind not in KINDS:
        return [f"kind={kind!r} not in {KINDS}"]
    _check(problems, isinstance(obj.get("ts"), (int, float)),
           "ts (wall clock) must be a number")
    _check(problems, isinstance(obj.get("t"), (int, float)),
           "t (monotonic) must be a number")
    if kind in ("event", "span"):
        _check(problems,
               isinstance(obj.get("name"), str) and obj["name"],
               "name must be a non-empty string")
    if kind in ("event", "span", "flight"):
        for f in _CTX_FIELDS:
            if f in obj:
                _check(problems,
                       isinstance(obj[f], str) and obj[f],
                       f"{f} must be a non-empty string when present")
    if kind == "event":
        rng = obj.get("range")
        _check(problems, rng is None or isinstance(rng, str),
               "range must be a string or null")
        st = obj.get("range_stack")
        _check(problems,
               isinstance(st, list) and all(isinstance(s, str)
                                            for s in st),
               "range_stack must be a list of strings")
    elif kind == "span":
        dur = obj.get("duration")
        _check(problems,
               isinstance(dur, (int, float)) and dur >= 0,
               "duration must be a non-negative number")
        parent = obj.get("parent")
        _check(problems, parent is None or isinstance(parent, str),
               "parent must be a string or null")
        _check(problems, isinstance(obj.get("attrs"), dict),
               "attrs must be an object")
    elif kind == "flight":
        et = obj.get("error_type")
        _check(problems, isinstance(et, str) and et,
               "error_type must be a non-empty string")
        _check(problems, isinstance(obj.get("error"), str),
               "error must be a string")
        op = obj.get("op")
        _check(problems, op is None or isinstance(op, str),
               "op must be a string or null")
        for f in ("n_spans", "n_events"):
            v = obj.get(f)
            _check(problems,
                   isinstance(v, int) and not isinstance(v, bool)
                   and v >= 0,
                   f"{f} must be a non-negative integer")
    else:  # metrics
        _check(problems, isinstance(obj.get("metrics"), dict),
               "metrics must be an object")
    return problems


def validate_jsonl(path: str) -> Tuple[int, List[str]]:
    """Validate a JSONL file; returns (n_valid_records, problems).
    Problems are prefixed with their 1-based line number."""
    n_ok = 0
    problems: List[str] = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                problems.append(f"line {lineno}: not JSON ({e.msg})")
                continue
            probs = validate_record(obj)
            if probs:
                problems.extend(f"line {lineno}: {p}" for p in probs)
            else:
                n_ok += 1
    return n_ok, problems


def validate_flight_bundle(path: str) -> Tuple[int, List[str]]:
    """Validate one flight-recorder JSONL bundle file: every line must
    be a valid record, line 1 must be the ``kind="flight"`` header, and
    the final line must be the ``kind="metrics"`` trailer. Returns
    (n_valid_records, problems)."""
    n_ok, problems = validate_jsonl(path)
    kinds: List[str] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                kinds.append("<garbage>")
                continue
            kinds.append(obj.get("kind") if isinstance(obj, dict)
                         else "<non-object>")
    if not kinds:
        problems.append("bundle is empty")
    else:
        if kinds[0] != "flight":
            problems.append(
                f"first record must be kind='flight', got {kinds[0]!r}")
        if kinds[-1] != "metrics":
            problems.append(
                f"last record must be kind='metrics', got {kinds[-1]!r}")
        if kinds.count("flight") != 1:
            problems.append("bundle must contain exactly one flight header")
    return n_ok, problems


_CHROME_PHASES = ("X", "B", "E", "b", "e", "i", "M")


def validate_chrome_trace(doc) -> List[str]:
    """Problems with a chrome://tracing / Perfetto JSON document as
    produced by :func:`raft_tpu_torch.obs.export.render_chrome_trace`
    ([] when valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, not an object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _CHROME_PHASES:
            problems.append(f"event {i}: ph={ph!r} not in {_CHROME_PHASES}")
            continue
        _check(problems,
               isinstance(ev.get("name"), str) and ev["name"],
               f"event {i}: name must be a non-empty string")
        _check(problems, isinstance(ev.get("ts"), (int, float)),
               f"event {i}: ts must be a number (microseconds)")
        _check(problems, "pid" in ev, f"event {i}: pid required")
        _check(problems, "tid" in ev, f"event {i}: tid required")
        if ph == "X":
            dur = ev.get("dur")
            _check(problems,
                   isinstance(dur, (int, float)) and dur >= 0,
                   f"event {i}: ph=X needs a non-negative dur")
        if ph in ("b", "e"):
            _check(problems, "id" in ev,
                   f"event {i}: async ph={ph} needs an id")
    return problems
