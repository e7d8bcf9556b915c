"""Per-session checkpoint/restore for StreamServe.

A serving engine dies (process kill, infrastructure fault, chaos drill);
its sessions must resume **bit-identically** on a restarted engine.  This
module snapshots every session's externally observable state at a drained
block boundary and rebuilds it:

  admission-queue residue   tokens submitted but not yet pumped (peeked,
                            never consumed — a checkpoint is read-only)
  FIFO fills                residual tokens in host-visible FIFOs, keyed
                            by **authored** channel key (placement-proof)
  host actor machines       per-member state dicts (the same flattening
                            ``carry_state`` feeds the hot-swap transplant)
  device stage state        per-partition ``DeviceStage`` trees — concrete
                            at the boundary because the engine force-drains
                            every batcher before snapshotting
  delivered results         per-egress output buffers as of the checkpoint

Storage reuses ``repro_torch.checkpoint``'s atomic manifest+npy layout (temp dir,
atomic rename, ``latest`` written last): a crash mid-checkpoint leaves the
previous complete step as the restore point.  Host token streams and actor
states are stored as pickled object arrays — exact Python/NumPy scalar
types round-trip, which bit-identity requires (a ``np.float32`` token that
came off the device must not come back as a Python float; NumPy promotion
rules differ).  Device state stays numeric npy.

Port of ``repro/serve_stream/recovery.py``: device-state tensors come to
the host as ``.cpu().numpy()`` (the reference's ``jax.device_get``), and a
restored session's device state goes back onto its partition's device as
tensors before its pipeline is rebuilt.

Recovery contract (docs/reliability.md):

  * everything up to the checkpoint is restored exactly; processing resumes
    from the checkpoint and is deterministic, so the final output stream is
    bit-identical to an uninterrupted run;
  * outputs the dead engine delivered *after* the checkpoint are delivered
    again (replayed) — never lost, never reordered.  The per-session replay
    bound (``queued + in_pipeline`` at the checkpoint) is reported in the
    ``RecoveryReport``;
  * tokens submitted after the checkpoint died with the old engine's
    admission queues — clients learn this from ``submitted`` vs their own
    counts and resubmit (at-least-once admission, exactly-once output up to
    the replay window).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core.xcf import XCF
from repro_torch.observability.trace_profile import authored_channel_key
from repro_torch.serve_stream.session import (
    ServeError,
    StreamSession,
    _flatten_device_state,
)

KIND = "streamserve/v1"


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


@dataclass
class SessionRecovery:
    """What one session looked like at the restore point."""

    sid: int
    finished: bool
    delivered_restored: int   # tokens already in the restored output buffers
    queued_tokens: int        # admission residue waiting to be pumped
    in_pipeline_tokens: int   # tokens inside FIFOs at the checkpoint

    @property
    def replay_bound(self) -> int:
        """Max tokens the client may see delivered twice: everything the
        dead engine could have delivered after the checkpoint."""
        return self.queued_tokens + self.in_pipeline_tokens


@dataclass
class RecoveryReport:
    step: int
    sessions: Dict[int, SessionRecovery] = field(default_factory=dict)

    @property
    def replayed_tokens_bound(self) -> int:
        return sum(
            s.replay_bound for s in self.sessions.values() if not s.finished
        )


# ---------------------------------------------------------------------------
# snapshot (engine thread, batchers drained)
# ---------------------------------------------------------------------------


def _obj_arr(values: List) -> np.ndarray:
    """Token stream -> 1-D object array (pickled; exact types round-trip)."""
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


def _to_numpy(v) -> np.ndarray:
    """A state leaf as a host numpy array (a tensor copied off its device;
    bfloat16, which numpy lacks, as float32)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(v)


def _host_view(state: Dict) -> Dict:
    """Actor-state dict with tensors materialized to numpy (picklable, and
    independent of any device tensor the engine later replaces)."""
    return {
        k: _to_numpy(v) if isinstance(v, torch.Tensor) else v
        for k, v in state.items()
    }


def _member_devices(program) -> Dict[str, torch.device]:
    """Authored device member -> the device of the partition running it."""
    out: Dict[str, torch.device] = {}
    for dp in program.device_programs().values():
        fused = dp.fused or {}
        for a in dp.actors:
            for m in fused.get(a) or (a,):
                out[m] = dp.device
    return out


def snapshot_server(server) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Flatten a server's session state into a checkpointable tree + JSON
    metadata.  Caller (the engine thread, or a stopped server's owner) must
    have drained every batcher first so no round is in flight."""
    for b in server._batchers.values():
        assert not b.pending, "snapshot requires drained batchers"
    tree: Dict[str, np.ndarray] = {}
    sessions_meta: Dict[str, Dict] = {}
    for s in list(server._sessions):
        p = s.pipeline
        m: Dict = {
            "closed": bool(s.closed),
            "finished": bool(s.finished.is_set()),
            "error": s.error,
            "submitted": int(s.submitted_tokens),
            "had_delivery": s.first_delivery_ns is not None,
            "delivered": {
                port: len(vals) for port, vals in s.results.items()
            },
            "queued": 0,
            "in_pipeline": 0,
        }
        for port, vals in s.results.items():
            tree[f"s{s.sid}/result/{port}"] = _obj_arr(list(vals))
        if not s.finished.is_set() and p is not None:
            # admission residue: peek, never consume — a checkpoint must
            # not perturb the stream it snapshots
            queued = 0
            for port, q in s.queues.items():
                q.snapshot_reader()
                toks = list(q.peek(q.count()))
                queued += len(toks)
                tree[f"s{s.sid}/queue/{port}"] = _obj_arr(toks)
            m["queued"] = queued
            # FIFO residue by authored channel key (fusion renames lowered
            # keys per placement; authored keys survive recompilation)
            fifo_keys: List[List] = []
            in_pipe = 0
            for key, f in p.fifos.items():
                n = f.count()
                if not n:
                    continue
                ak = authored_channel_key(p.module, key)
                tree[f"s{s.sid}/fifo/{len(fifo_keys)}"] = _obj_arr(
                    list(f.peek(n))
                )
                fifo_keys.append(list(ak))
                in_pipe += n
            m["fifo_keys"] = fifo_keys
            m["in_pipeline"] = in_pipe
            # actor + device state through the hot-swap flattening: host
            # actors (fused members included) pickle whole state dicts;
            # device members store numeric leaves
            carry = p.carry_state()
            dev_members = set()
            for stage in p.stages.values():
                dev_members.update(_flatten_device_state(stage))
            host_actors = []
            for name, st in carry.items():
                if name in dev_members:
                    for k, v in st.items():
                        tree[f"s{s.sid}/dev/{name}/{k}"] = _to_numpy(v)
                else:
                    host_actors.append(name)
                    tree[f"s{s.sid}/host/{name}"] = _obj_arr(
                        [_host_view(st)]
                    )
            m["host_actors"] = sorted(host_actors)
            m["dev_members"] = sorted(dev_members)
        sessions_meta[str(s.sid)] = m
    extra = {
        "kind": KIND,
        "network": server._program.graph.name,
        "xcf": json.loads(server._program.xcf.to_json()),
        "degraded": sorted(server._quarantined),
        "round": server._round,
        "next_sid": server._next_sid,
        "serve_opts": server.serve_opts(),
        "sched": {
            "last_round": {
                str(k): v for k, v in server._sched._last_round.items()
            },
            "served": {
                str(k): v for k, v in server._sched._served.items()
            },
        },
        "sessions": sessions_meta,
    }
    return tree, extra


def write_checkpoint(server, ckpt_dir, *, step: int, keep: int = 3):
    """Snapshot + atomic write via ``repro_torch.checkpoint.save``."""
    tree, extra = snapshot_server(server)
    return ckpt.save(ckpt_dir, step, tree, extra=extra, keep=keep)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def recover(
    program,
    ckpt_dir,
    *,
    step: Optional[int] = None,
    **serve_kwargs,
):
    """Rebuild a ``StreamServer`` from the last complete checkpoint.

    ``program`` is any compilation of the checkpointed network — if its
    placement differs from the checkpointed XCF, it is repartitioned to
    match first (state and FIFO residue belong to that placement).  Extra
    keyword arguments override the saved serve options (e.g. a recovered
    server may enable tracing or chaos).  Returns the server, not started;
    its ``.recovery`` holds the :class:`RecoveryReport`."""
    from repro_torch.serve_stream.engine import StreamServer

    if step is None:
        step = ckpt.latest_step(ckpt_dir)
    if step is None:
        raise ServeError(f"no complete checkpoint under {ckpt_dir}")
    flat, extra = ckpt.load_flat(ckpt_dir, step)
    if extra.get("kind") != KIND:
        raise ServeError(
            f"{ckpt_dir} step {step} is not a StreamServe checkpoint "
            f"(kind={extra.get('kind')!r})"
        )
    if extra["network"] != program.graph.name:
        raise ServeError(
            f"checkpoint is for network {extra['network']!r}, "
            f"got program for {program.graph.name!r}"
        )
    xcf = XCF.from_json(json.dumps(extra["xcf"]))
    if xcf.assignment() != program.xcf.assignment():
        program = program.repartition(xcf=xcf)
    opts = dict(extra.get("serve_opts") or {})
    opts.update(serve_kwargs)
    server = StreamServer(program, **opts)
    member_device = _member_devices(program)
    report = RecoveryReport(step=step)
    now = time.perf_counter_ns()
    with server._lock:
        for sid_s, m in sorted(
            extra["sessions"].items(), key=lambda kv: int(kv[0])
        ):
            sid = int(sid_s)
            s = StreamSession(
                sid, server, server.ingress_ports, server.egress_ports,
                server.admission_depth,
            )
            s.closed = m["closed"]
            s.error = m.get("error")
            s.submitted_tokens = m.get("submitted", 0)
            # SLO clocks restart: a session that had already delivered must
            # not re-observe TTFO for its replayed first block
            s.first_submit_ns = now
            if m.get("had_delivery"):
                s.first_delivery_ns = now
                s.last_delivery_ns = now
            for port in s.results:
                arr = flat.get(f"s{sid}/result/{port}")
                if arr is not None and arr.size:
                    s.results[port].extend(arr.tolist())
            if m.get("finished"):
                s.pipeline = server._build_pipeline(s)
                s.finished.set()
            else:
                for port, q in s.queues.items():
                    arr = flat.get(f"s{sid}/queue/{port}")
                    if arr is not None and arr.size:
                        q.write(arr.tolist())
                        q.publish_writer()
                carry: Dict[str, Dict] = {}
                for name in m.get("host_actors", ()):
                    carry[name] = flat[f"s{sid}/host/{name}"][0]
                for member in m.get("dev_members", ()):
                    prefix = f"s{sid}/dev/{member}/"
                    dev = member_device.get(member, torch.device("cpu"))
                    carry[member] = {
                        key[len(prefix):]: torch.from_numpy(arr).to(dev)
                        for key, arr in flat.items()
                        if key.startswith(prefix)
                    }
                residue = {
                    tuple(ak): flat[f"s{sid}/fifo/{i}"].tolist()
                    for i, ak in enumerate(m.get("fifo_keys", ()))
                }
                s.pipeline = server._build_pipeline(
                    s, carry=carry, carry_fifos=residue
                )
                server.telemetry.count("sessions_opened")
                server._g_active.add(1)
                server._c_recoveries.inc()
            server._sessions.append(s)
            report.sessions[sid] = SessionRecovery(
                sid=sid,
                finished=bool(m.get("finished")),
                delivered_restored=sum(
                    m.get("delivered", {}).values()
                ),
                queued_tokens=m.get("queued", 0),
                in_pipeline_tokens=m.get("in_pipeline", 0),
            )
        server._next_sid = max(
            extra.get("next_sid", 0),
            max((s.sid + 1 for s in server._sessions), default=0),
        )
        server._round = extra.get("round", 0)
        server._ckpt_step = step
        live = {
            s.sid for s in server._sessions if not s.finished.is_set()
        }
        sched = extra.get("sched") or {}
        server._sched._last_round = {
            int(k): v
            for k, v in (sched.get("last_round") or {}).items()
            if int(k) in live
        }
        server._sched._served = {
            int(k): v
            for k, v in (sched.get("served") or {}).items()
            if int(k) in live
        }
    server.recovery = report
    return server
