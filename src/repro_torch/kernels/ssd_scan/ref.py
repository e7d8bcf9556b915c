"""Plain PyTorch versions of the SSD-scan kernel (``ssd_scan_fwd`` of
``repro/kernels/ssd_scan/kernel.py``) and the reference's sequential oracle.

* :func:`ssd_scan_ref` is the kernel's math: the chunked dual form, one chunk
  after another with the ``(P, N)`` state carried across, all float32 inside
  (float64 for float64 inputs), ``y`` in ``x.dtype`` and the final state in
  float32.  The CUDA kernel is
  held to it on the card; ``ops.ssd_scan`` runs it for CPU tensors.
* :func:`ssd_ref` is a port of ``repro/kernels/ssd_scan/ref.py``: the exact
  token-by-token recurrence, for the tests.
* :func:`ssd_staged_ref` computes the same function in the three stages of
  the bfloat16 CUDA kernels (chunk states, state passing, chunk outputs),
  optionally with operands rounded where the tensor cores take them; the
  CPU tests hold it to the JAX package.  Nothing on the main path calls it.
* :func:`ssd_scan_bwd_ref` is the backward in the stages of the bfloat16
  backward kernels (chunk states and the chunks' state cotangents, the
  reverse state pass, the key and query sides of each chunk, the cumsum's
  reverse); the CPU tests hold it in float64 to the vjp of
  ``model/ssm.py::ssd_chunked`` and the card holds the kernels to it.

Layout (the kernel's): x ``(BH, S, P)``; dt and ``da = dt * A`` ``(BH, S)``
float32; B and C ``(B, S, N)``, shared by the ``nheads`` heads of a batch row
(row ``bh`` reads ``bh // nheads``).
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, *, nheads: int, chunk: int):
    """Returns ``(y (BH, S, P) in x.dtype, final state (BH, P, N) float32)``."""
    BH, S, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk {Q}")
    f32 = torch.promote_types(x.dtype, torch.float32)  # float64 stays (gradcheck)
    Bh = B_.to(f32).repeat_interleave(nheads, dim=0)  # (BH, S, N)
    Ch = C_.to(f32).repeat_interleave(nheads, dim=0)
    xf, dtf, daf = x.to(f32), dt.to(f32), da.to(f32)
    rows = torch.arange(Q, device=x.device)
    causal = rows[:, None] >= rows[None, :]
    state = torch.zeros((BH, P, N), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xc, dtc = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]
        bc, cc = Bh[:, c0:c0 + Q], Ch[:, c0:c0 + Q]
        a_cs = torch.cumsum(daf[:, c0:c0 + Q], dim=1)  # (BH, Q)
        seg = a_cs[:, :, None] - a_cs[:, None, :]  # (BH, Q, K)
        # select, never multiply by a mask: exp overflows above the diagonal
        L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
        scores = torch.bmm(cc, bc.transpose(1, 2))  # (BH, Q, K)
        w = scores * L * dtc[:, None, :]
        y_diag = torch.bmm(w, xc)  # (BH, Q, P)
        y_inter = torch.bmm(cc, state.transpose(1, 2)) * torch.exp(a_cs)[:, :, None]
        decay_to_end = torch.exp(a_cs[:, -1:] - a_cs) * dtc  # (BH, Q)
        state = state * torch.exp(a_cs[:, -1])[:, None, None] + torch.bmm(
            xc.transpose(1, 2), bc * decay_to_end[:, :, None]
        )
        ys.append(y_diag + y_inter)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y.to(x.dtype), state


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor, B_: torch.Tensor,
            C_: torch.Tensor, *, nheads: int):
    """The sequential recurrence: ``state = state * exp(da) + dt * x B^T``,
    ``y = C . state``, one token at a time.  Returns ``(y in x.dtype, final
    state float32)``."""
    BH, S, P = x.shape
    N = B_.shape[-1]
    Bh = B_.float().repeat_interleave(nheads, dim=0)
    Ch = C_.float().repeat_interleave(nheads, dim=0)
    xf, dtf, daf = x.float(), dt.float(), da.float()
    state = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state = state * torch.exp(daf[:, t])[:, None, None] + (
            dtf[:, t, None, None] * xf[:, t, :, None] * Bh[:, t, None, :]
        )
        ys.append(torch.einsum("bn,bpn->bp", Ch[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _pair(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a bf16 pair ``hi + lo`` summed in float32: about 16 bits."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def rising_pairs(da: torch.Tensor, Q: int) -> torch.Tensor:
    """(BH, S / Q) bool: chunks at or after a chunk of their row with some
    ``da > 0``, where the bfloat16 kernels take W and the entering state as
    bf16 pairs.  Where da <= 0 (a model's dt > 0, A < 0) there is none."""
    up = (da.float().reshape(da.shape[0], -1, Q) > 0).any(dim=2)
    return torch.cummax(up.to(torch.int32), dim=1).values.bool()


def ssd_staged_ref(x: torch.Tensor, dt: torch.Tensor, da: torch.Tensor, B_: torch.Tensor,
                   C_: torch.Tensor, *, nheads: int, chunk: int, rounded: bool = False):
    """The function of :func:`ssd_scan_ref` in the kernels' three stages.

    1. Chunk states: ``S_c = (x_c * s)^T B_c`` with ``s = exp(a_last -
       a_cs) * dt``, each chunk on its own (the reference scales B instead).
    2. State passing: ``H_0 = 0``, ``H_{c+1} = H_c * exp(a_last_c) + S_c``;
       the last is the final state.
    3. Chunk outputs: ``G = C_c B_c^T`` (once per batch row, shared by its
       heads), ``y = (G o L o dt) x + (C_c H_c^T) * exp(a_cs)``.

    With ``rounded`` the operands are rounded where the bfloat16 kernels'
    tensor cores take them: the scaled x of stage 1 as a bf16 pair ``hi +
    lo`` (``hi = bf16(v)``, ``lo = bf16(v - hi)``); the weights ``G o L o
    dt`` and the state entering a chunk to bf16, or, in a chunk of a row
    where a_cs has risen (some ``da > 0`` in it or an earlier chunk:
    ``rising_pairs``), each as a pair too; x, B and C enter as they are.
    Sums stay float32.  Returns ``(y in x.dtype, final state float32)``.
    """
    BH, S, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk {Q}")
    nc = S // Q
    xf = x.float().reshape(BH, nc, Q, P)
    dtf = dt.float().reshape(BH, nc, Q)
    a_cs = torch.cumsum(da.float().reshape(BH, nc, Q), dim=2)
    Bh = B_.float().repeat_interleave(nheads, dim=0).reshape(BH, nc, Q, N)
    Cb = C_.float().reshape(-1, nc, Q, N)

    # 1. chunk states
    scale = torch.exp(a_cs[..., -1:] - a_cs) * dtf  # (BH, nc, Q)
    xs = xf * scale[..., None]
    if rounded:
        xs = _pair(xs)
    states = torch.matmul(xs.transpose(2, 3), Bh)  # (BH, nc, P, N)

    # 2. state passing
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * torch.exp(a_cs[:, c, -1])[:, None, None] + states[:, c]
    H = torch.stack(entering, dim=1)  # (BH, nc, P, N), the state entering each chunk
    if rounded:
        pair = rising_pairs(da, Q)[..., None, None]
        H = torch.where(pair, _pair(H), _bf16(H))

    # 3. chunk outputs
    G = torch.matmul(Cb, B_.float().reshape(-1, nc, Q, N).transpose(2, 3))  # (B, nc, Q, Q)
    G = G.repeat_interleave(nheads, dim=0)  # shared by the heads of a batch row
    rows = torch.arange(Q, device=x.device)
    causal = rows[:, None] >= rows[None, :]
    seg = a_cs[..., :, None] - a_cs[..., None, :]
    L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    W = G * L * dtf[..., None, :]
    if rounded:
        W = torch.where(pair, _pair(W), _bf16(W))
    Ch = Cb.repeat_interleave(nheads, dim=0)
    y = torch.matmul(W, xf) + torch.matmul(Ch, H.transpose(2, 3)) * torch.exp(a_cs)[..., None]
    return y.reshape(BH, S, P).to(x.dtype), h


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
                     C_: torch.Tensor, dy: torch.Tensor, dstate, *, nheads: int, chunk: int):
    """The vjp of :func:`ssd_scan_ref` (``da = dt * A`` of the row's head)
    in the stages of the bfloat16 backward kernels, every chunk at once
    where the kernels split by chunk.  ``dy`` (BH, S, P) is y's cotangent,
    ``dstate`` (BH, P, N) the final state's or ``None`` (zero).  Float32
    inside, float64 for float64 inputs.  Per chunk, with ``s = exp(a_last -
    a_cs) * dt``, ``L`` the decay (a select before the exponential), ``G =
    C B^T`` and ``W = G o L o dt``:

    1. ``S_c = (x o s)^T B`` (the forward's chunk state) and ``E_c = (dy o
       exp(a_cs))^T C``, the cotangent y sends into the entering state.
    2. ``H_c`` entering each chunk, as the forward passes it; then from the
       last chunk back ``D_c``, the cotangent of the state leaving chunk c:
       ``D_last = dstate``, ``D_{c-1} = D_c exp(a_last_c) + E_c``; and
       ``exp(a_last_c) sum(H_c o D_c)``, a_last's share of it.
    3. Keys: ``dW = dy x^T``, ``dS = dW o L o dt`` summed over a batch
       row's heads; ``dx = W^T dy + s o (B D^T)``, ``dB = sum_h dS^T C + s
       o (x D)``; per key ``Z = sum_p x o (B D^T)`` (s's cotangent) and
       ``sum_q dW o G o L`` (dt's through W).
    4. Queries: ``dC = sum_h dS B + exp(a_cs) o (dy H)``; per query
       ``sum_k dW o W + exp(a_cs) sum_n C o (dy H)`` (a_cs's through L and
       y's carried part).
    5. a_cs's cotangent, reversed through the cumsum into da's, then dt's
       and A's.

    Returns ``(dx in x.dtype, ddt float32 (BH, S), dA float32 (nheads,), dB,
    dC in B's dtype)``."""
    BH, S, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk {Q}")
    nc, Bb = S // Q, BH // nheads
    f32 = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(f32).reshape(BH, nc, Q, P)
    dyf = dy.to(f32).reshape(BH, nc, Q, P)
    dtf = dt.to(f32).reshape(BH, nc, Q)
    Ah = A.to(f32).repeat(Bb)  # (BH,): the row's head
    da = dt.to(f32) * Ah[:, None]
    a_cs = torch.cumsum(da.reshape(BH, nc, Q), dim=2)
    a_last = a_cs[..., -1]  # (BH, nc)
    Bh = B_.to(f32).repeat_interleave(nheads, dim=0).reshape(BH, nc, Q, N)
    Ch = C_.to(f32).repeat_interleave(nheads, dim=0).reshape(BH, nc, Q, N)
    e_in = torch.exp(a_cs)  # exp(a_cs[q]): y's carried part
    to_end = torch.exp(a_last[..., None] - a_cs)
    s = to_end * dtf

    # 1. the chunk states and the chunks' cotangents into the entering state
    states = torch.matmul((xf * s[..., None]).transpose(2, 3), Bh)  # (BH, nc, P, N)
    E = torch.matmul((dyf * e_in[..., None]).transpose(2, 3), Ch)

    # 2. the entering states forward, their cotangents backward
    h = torch.zeros((BH, P, N), dtype=f32, device=x.device)
    H = []
    for c in range(nc):
        H.append(h)
        h = h * torch.exp(a_last[:, c])[:, None, None] + states[:, c]
    H = torch.stack(H, dim=1)
    d = (torch.zeros_like(h) if dstate is None else dstate.to(f32))
    D = [None] * nc
    for c in reversed(range(nc)):
        D[c] = d
        d = d * torch.exp(a_last[:, c])[:, None, None] + E[:, c]
    D = torch.stack(D, dim=1)
    d_last = torch.exp(a_last) * (H * D).sum(dim=(2, 3))  # (BH, nc)

    # 3. and 4. the chunk's products
    rows = torch.arange(Q, device=x.device)
    causal = rows[:, None] >= rows[None, :]
    seg = a_cs[..., :, None] - a_cs[..., None, :]
    L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)  # (BH, nc, Q, K)
    G = torch.matmul(Ch, Bh.transpose(2, 3))
    dW = torch.matmul(dyf, xf.transpose(2, 3))
    dWL = dW * L
    W = G * L * dtf[..., None, :]
    dS = (dWL * dtf[..., None, :]).reshape(Bb, nheads, nc, Q, Q).sum(dim=1)
    BD = torch.matmul(Bh, D.transpose(2, 3))  # (BH, nc, Q, P)
    dx = torch.matmul(W.transpose(2, 3), dyf) + s[..., None] * BD
    Z = (xf * BD).sum(dim=3)
    colT = (dWL * G).sum(dim=2)  # per key
    Bc = B_.to(f32).reshape(Bb, nc, Q, N)
    Cc = C_.to(f32).reshape(Bb, nc, Q, N)
    xD = (s[..., None] * torch.matmul(xf, D)).reshape(Bb, nheads, nc, Q, N).sum(dim=1)
    dB = torch.matmul(dS.transpose(2, 3), Cc) + xD
    dyH = e_in[..., None] * torch.matmul(dyf, H)  # (BH, nc, Q, N)
    dC = torch.matmul(dS, Bc) + dyH.reshape(Bb, nheads, nc, Q, N).sum(dim=1)
    dq = (dW * W).sum(dim=3) + (Ch * dyH).sum(dim=3)  # per query

    # 5. a_cs's cotangent, then da's (the cumsum reversed), dt's and A's
    zs = Z * s
    d_a = dq - dtf * colT - zs
    d_a[..., -1] += d_last + zs.sum(dim=2)
    d_da = torch.flip(torch.cumsum(torch.flip(d_a, (2,)), dim=2), (2,))
    ddt = d_da * Ah[:, None, None] + colT + Z * to_end
    dA = (d_da * dtf).reshape(Bb, nheads, S).sum(dim=(0, 2))
    return (dx.reshape(BH, S, P).to(x.dtype), ddt.reshape(BH, S), dA,
            dB.reshape(Bb, S, N).to(B_.dtype), dC.reshape(Bb, S, N).to(C_.dtype))
