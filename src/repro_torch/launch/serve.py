"""Batched serving entry point: prefill, then greedy decode until every sequence
has emitted EOS or the length budget is spent (port of
``repro/launch/serve.py``).

The reference's decode is one jitted ``lax.while_loop``; here it is a Python
loop over ``lm.decode_step`` that reads one flag per step ("is every
sequence done?") from the card and stops there: the idleness rule.  The
first decode step writes at position ``S_p`` (the position after the
prompt); the reference's loop passes ``S_p + i`` from ``i = 1``, one
position further, which leaves one empty key in every attention cache (an
SSM model is unaffected).  ROADMAP C records it.

``make_generate(cfg, mesh, rules, ...)`` runs prefill and decode under
``shard_ctx(mesh, rules)``, as the reference's: parameters placed as
DTensors (``distributed/sharding.py::place``), the prompt placed by its
``("batch", "seq")`` axes, the prefill cache spliced into the decode cache
by padding and constrained to ``lm.cache_logical`` (one splice, with or
without a context); the emitted tokens are
gathered to every rank.  ``mesh=None`` generates without a context.

``device=None`` means ``cuda:0`` and raises when CUDA is not available;
``device="cpu"`` serves on the CPU with the kernels' plain versions.

Usage (reduced config, on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --device cpu
Options: --full (the published widths), --batch, --prompt-len, --max-new,
--seed.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.steps import serving_mode
from repro_torch.model import lm
from repro_torch.model.layers import resolve_device
from repro_torch.pytree import tree_flatten


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, sh.DTensor) else t


def _splice(cfg, small, B: int, max_len: int):
    """The prefill cache padded with zeros into a ``max_len`` decode cache,
    each leaf constrained to its ``cache_logical`` axes (the reference's
    ``jnp.pad`` splice; ``constrain`` is the identity without a context)."""
    big = lm.init_cache(cfg, B, max_len, device="meta")
    logical = lm.cache_logical(cfg)
    out = {}
    for key, leaves in small.items():
        out[key] = {}
        for name, s in leaves.items():
            pads = []
            for b, n in zip(reversed(big[key][name].shape), reversed(s.shape)):
                pads += [0, b - n]
            out[key][name] = sh.constrain(F.pad(s.to(big[key][name].dtype), pads),
                                          logical[key][name])
    return out


def prefill_cache(params, cfg, prompt_tokens: torch.Tensor, max_len: int):
    """Prefill ``prompt_tokens (B, S_p)`` and splice its cache into the
    leading corner of a ``max_len`` decode cache.  Returns ``(last-token
    logits (B, Vp) float32, cache)``."""
    with serving_mode():
        logits, small = lm.prefill(params, cfg, tokens=prompt_tokens)
        return logits, _splice(cfg, small, prompt_tokens.shape[0], max_len)


def greedy_decode(params, cfg, cache, tok0: torch.Tensor, S_p: int, *, max_new: int,
                  eos_id: int = 2) -> Tuple[torch.Tensor, int]:
    """Greedy decode from the first tokens ``tok0`` at position ``S_p``.
    Returns ``(tokens (B, max_new) int32 with tok0 first, steps)``; a finished
    sequence pads with ``eos_id``.  Inside a ``shard_ctx`` the tokens are
    gathered each step and enter the next step replicated."""
    with serving_mode():
        tok0 = _full(tok0)
        B = tok0.shape[0]
        out = torch.zeros((B, max_new), dtype=torch.int32, device=tok0.device)
        out[:, 0] = tok0
        done = tok0 == eos_id
        tok, i = tok0, 1
        while i < max_new and not bool(done.all()):
            logits, cache = lm.decode_step(params, cfg, cache, sh.replicate(tok), S_p + i - 1)
            nxt = _full(torch.argmax(logits, -1)).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            out[:, i] = nxt
            done = done | (nxt == eos_id)
            tok, i = nxt, i + 1
        return out, i


def make_generate(cfg, mesh, rules, *, max_new: int, eos_id: int = 2):
    """``generate(params, prompt_tokens)`` under ``shard_ctx(mesh, rules)``
    (``mesh=None``: no context).  Plain parameters or prompt are placed on
    the mesh first."""
    shardings = sh.defs_shardings(lm.model_defs(cfg), mesh, rules) if mesh is not None else None

    def run(params, prompt_tokens):
        S_p = prompt_tokens.shape[1]
        logits, cache = prefill_cache(params, cfg, prompt_tokens, S_p + max_new)
        tok0 = torch.argmax(logits, -1).to(torch.int32)
        return greedy_decode(params, cfg, cache, tok0, S_p, max_new=max_new, eos_id=eos_id)

    def generate(params, prompt_tokens: torch.Tensor):
        """prompt_tokens: (B, S_p) int -> (tokens (B, max_new), n_steps)."""
        if mesh is None:
            return run(params, prompt_tokens)
        leaves, treedef = tree_flatten(params)
        if not isinstance(leaves[0], sh.DTensor):
            params = sh.place(params, shardings)
        with sh.shard_ctx(mesh, rules):
            if not isinstance(prompt_tokens, sh.DTensor):
                prompt_tokens = sh.distribute_tensor(
                    prompt_tokens, mesh, sh.ctx_placements(("batch", "seq"), prompt_tokens.shape))
            return run(params, prompt_tokens)

    return generate


def run_serving(
    arch: str = "smollm-135m",
    *,
    batch: int = 4,
    prompt_len: int = 16,
    max_new: int = 24,
    reduced: bool = True,
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
    quiet: bool = False,
) -> Dict:
    """Serve one batch of seeded random prompts with random weights from
    ``seed``.  Returns the tokens and the prefill and decode times (host
    clock, each ending in a synchronisation with the card)."""
    dev = resolve_device(device, "run_serving")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.frontend != "none":
        raise ValueError("run_serving serves token-in archs (cfg.frontend == 'none')")
    params = lm.init_model(cfg, seed, device=dev)
    rng = np.random.default_rng(seed + 1)
    prompts = torch.as_tensor(
        rng.integers(3, cfg.vocab_size, (batch, prompt_len)).astype(np.int32), device=dev
    )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill_cache(params, cfg, prompts, prompt_len + max_new)
    tok0 = torch.argmax(logits, -1).to(torch.int32)
    sync()
    t1 = time.perf_counter()
    out, steps = greedy_decode(params, cfg, cache, tok0, prompt_len, max_new=max_new)
    sync()
    t2 = time.perf_counter()
    prefill_s, decode_s = t1 - t0, t2 - t1
    toks = batch * steps
    if not quiet:
        print(
            f"{arch}: prefill {batch}x{prompt_len} in {prefill_s:.3f}s "
            f"({batch * prompt_len / prefill_s:.1f} tok/s); decoded {steps} steps x "
            f"{batch} seqs in {decode_s:.3f}s ({batch * (steps - 1) / max(decode_s, 1e-9):.1f} "
            f"tok/s); idleness-terminated={steps < max_new}"
        )
    return {
        "arch": arch, "device": str(dev), "steps": steps, "tokens": toks,
        "seconds": prefill_s + decode_s, "prefill_seconds": prefill_s,
        "decode_seconds": decode_s, "tokens_per_s": toks / (prefill_s + decode_s),
        "output": out.cpu().numpy(), "prompts": prompts.cpu().numpy(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' for the CPU")
    args = ap.parse_args()
    run_serving(
        args.arch, batch=args.batch, prompt_len=args.prompt_len, max_new=args.max_new,
        reduced=not args.full, seed=args.seed, device=args.device,
    )


if __name__ == "__main__":
    main()
