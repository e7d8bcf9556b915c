"""Chrome-trace / Perfetto JSON export + schema validation.

``chrome_trace(recorder)`` renders a ``TraceRecorder``'s event stream in
the Trace Event Format (the JSON ``chrome://tracing`` / Perfetto /
``ui.perfetto.dev`` all open): one ``pid`` for the whole run, one ``tid``
per *track* (scheduler thread, PLink lane, serve session), ``"M"``
thread_name metadata rows naming each track, ``"X"`` complete spans with
microsecond timestamps relative to the recorder's epoch, ``"i"`` instants,
and ``"C"`` counters.

``validate_chrome_trace(payload)`` is the schema check the test suite and
the CI smoke bench run over every exported artifact — it returns a list of
human-readable violations (empty = valid) so a malformed export fails
loudly instead of rendering as a blank tracing tab.

Copy of ``repro/observability/chrome.py``.  Edit: ``otherData`` carries the
recorder's clock anchor.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Union

from repro_torch.observability.recorder import TraceRecorder

PID = 1  # one process per trace; tracks split by tid

_KINDS = {"X", "i", "C", "M"}


def chrome_trace(rec: TraceRecorder) -> Dict:
    """Render the recorder as a Trace Event Format payload (JSON object
    form: ``{"traceEvents": [...], ...}``)."""
    tids: Dict[str, int] = {}
    events: List[Dict] = []
    t0 = rec.t0_ns

    def tid_of(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = len(tids) + 1
            tids[track] = tid
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": PID,
                "tid": tid,
                "args": {"name": track},
            })
        return tid

    for kind, track, name, cat, ts_ns, dur_ns, args in rec.events():
        tid = tid_of(track)
        ev: Dict = {
            "name": name,
            "cat": cat,
            "ph": kind,
            "pid": PID,
            "tid": tid,
            "ts": (ts_ns - t0) / 1e3,  # Chrome wants microseconds
        }
        if kind == "X":
            ev["dur"] = dur_ns / 1e3
        if kind == "i":
            ev["s"] = "t"  # thread-scoped instant
        if args:
            ev["args"] = args
        events.append(ev)

    drops = rec.drops()
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "recorder": "repro_torch.observability",
            "events": rec.total_events(),
            "dropped": drops,  # explicit drop accounting, per thread
            # lines the spans up with a torch.profiler trace (Unix clock)
            "clock_anchor": dict(zip(("perf_counter_ns", "time_ns"), rec.clock_anchor)),
            **rec.meta,
        },
    }


def write_chrome_trace(
    rec_or_payload: Union[TraceRecorder, Dict], path
) -> Dict:
    """Serialize a recorder (or an already-rendered payload) to ``path``;
    returns the payload."""
    payload = (
        chrome_trace(rec_or_payload)
        if isinstance(rec_or_payload, TraceRecorder)
        else rec_or_payload
    )
    Path(path).write_text(json.dumps(payload))
    return payload


def load_trace(src: Union[Dict, str, Path]) -> Dict:
    """Accept a payload dict or a path to one (the artifact file)."""
    if isinstance(src, dict):
        return src
    return json.loads(Path(src).read_text())


def validate_chrome_trace(
    payload: Union[Dict, str, Path],
    *,
    require_cats: Optional[List[str]] = None,
    require_tracks: Optional[List[str]] = None,
) -> List[str]:
    """Schema-check a trace payload; returns violations (empty = valid).

    Beyond the structural Trace Event Format rules, callers may require
    specific categories (e.g. ``["actor", "plink"]``) or track names to be
    present — the golden-structure assertions the test suite and the CI
    artifact check make.
    """
    errors: List[str] = []
    try:
        payload = load_trace(payload)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable trace: {e}"]
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    tracks: Dict[int, str] = {}
    cats = set()
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KINDS:
            errors.append(f"{where}: ph {ph!r} not one of {sorted(_KINDS)}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int) or not isinstance(
            ev.get("tid"), int
        ):
            errors.append(f"{where}: pid/tid must be ints")
            continue
        if ph == "M":
            if ev["name"] == "thread_name":
                name = (ev.get("args") or {}).get("name")
                if not name:
                    errors.append(f"{where}: thread_name without args.name")
                else:
                    tracks[ev["tid"]] = name
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: X event needs non-negative dur")
        if ph == "C":
            val = (ev.get("args") or {}).get("value")
            if not isinstance(val, (int, float)):
                errors.append(f"{where}: C event needs numeric args.value")
        if ev["tid"] not in tracks:
            errors.append(
                f"{where}: tid {ev['tid']} has no thread_name metadata"
            )
        if ev.get("cat"):
            cats.add(ev["cat"])
    names = set(tracks.values())
    for cat in require_cats or ():
        if cat not in cats:
            errors.append(f"required category {cat!r} absent (have "
                          f"{sorted(cats)})")
    for track in require_tracks or ():
        if not any(t == track or t.startswith(track) for t in names):
            errors.append(f"required track {track!r} absent (have "
                          f"{sorted(names)})")
    return errors
