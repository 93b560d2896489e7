"""Public wrappers around the hand-written kernels.

Each wrapper dispatches on the device of its tensors: a CUDA tensor goes
to the kernel (or the call raises), a CPU tensor goes to the plain PyTorch
version in ``kernels.ref``. Each keeps a count of its kernel launches, so
a run can show that its main path went through the kernel."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import count_launch, ref, ssd_scan
from repro_torch.kernels.elastic_update import elastic_sgd_update


def fused_elastic_update(params, mom, grads, w_sum, running, lr, *,
                         momentum: float = 0.9):
    """Fused Eq.-(5) renormalization + gated momentum-SGD apply over the
    replica-blocked flat (R, P) layout; updates ``params`` and ``mom`` IN
    PLACE and returns them.

    On CUDA tensors this launches the kernel (``kernels.elastic_update``)
    and adds one to ``fused_elastic_update.launches``; on CPU tensors it
    runs ``ref.elastic_update_reference`` and copies the result back."""
    if params.device.type == "cpu":
        p_new, v_new = ref.elastic_update_reference(
            params, mom, grads, w_sum, running, lr, momentum=momentum)
        params.copy_(p_new)
        mom.copy_(v_new)
        return params, mom
    elastic_sgd_update(params, mom, grads, w_sum, running, lr,
                       momentum=momentum)
    count_launch(fused_elastic_update)
    return params, mom


fused_elastic_update.launches = 0


def flash_mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0):
    """Model-layout attention: q (B, S, H, D), k/v (B, T, Hkv, D) ->
    (B, S, H, D), differentiable.

    On CUDA tensors this runs K2 (``kernels.flash_attention``): the
    forward, dK/dV and dQ kernels of the dtype (tensor cores for bf16,
    CUDA cores for float32), each counting its launches. The kernels
    read the model's layout through transposed views, and the output and
    gradients come back in it, so nothing is copied where the head_dim is
    64 or 128 (any other up to 128 is zero-padded to the next of them). On
    CPU tensors it runs ``ref.mha_reference`` under autograd."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.device.type == "cpu":
        out = ref.mha_reference(qt, kt, vt, causal=causal, window=window,
                                q_offset=q_offset)
    else:
        out = flash.flash_attention(qt, kt, vt, causal=causal,
                                    window=window, q_offset=q_offset)
    return out.transpose(1, 2)


def ssd_chunked(xh, dt, a_h, bm, cm, *, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: xh (B, S, H, P), dt (B, S, H) (post-softplus), a_h (H,)
    (negative), bm/cm (B, S, G, N), the chunk ``min(chunk, S)`` dividing S,
    and an optional initial state h0 (B, H, P, N) (the prefill's cached
    state; zeros when None). Returns (y (B, S, H, P) in xh's dtype, final
    state (B, H, P, N) float32), as ``models.ssm.ssd_chunked``.

    The intra-chunk terms come from K3 on the tensor cores
    (``kernels.ssd_scan.ssd_chunk``) on CUDA tensors of either dtype,
    counted in ``ssd_chunked.launches``, and from
    ``ref.ssd_chunk_reference`` on CPU tensors. The inter-chunk recurrence
    h_c = decay_c·h_{c−1} + state_c and y_inter = exp(cs)·(C·h_{c−1}) run
    here in plain torch, y_inter rounded to xh's dtype before it joins
    y_intra, as the reference's ``ops.ssd_chunked_pallas`` rounds."""
    b, s, h, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    q = ssd_scan.chunk_len(chunk, s)
    nc, rep = s // q, h // g
    dt, a_h = dt.to(torch.float32), a_h.to(torch.float32)
    if xh.device.type == "cpu":
        y_intra, states, cs, decay = ref.ssd_chunk_reference(
            xh, dt, a_h, bm, cm, chunk=q)
    else:
        y_intra, states, cs, decay = ssd_scan.ssd_chunk(
            xh, dt, a_h, bm, cm, chunk=q)
        count_launch(ssd_chunked)
    f32 = torch.float32
    # the state entering each chunk, laid out (B, nc, G, N, rep·P) so one
    # batched product per (batch, chunk, group) gives every head of the
    # group: C (Q, N) @ h (N, rep·P). Scaling by exp(cs) after the product
    # keeps C unrepeated; torch.einsum would contract the reference's
    # "bcqhn,bchnp,bchq" pairwise through a (B, nc, Q, H, N, P) tensor.
    hprev = (torch.zeros((b, h, n, p), dtype=f32, device=xh.device)
             if h0 is None else h0.to(f32).transpose(-1, -2))
    hprevs = torch.empty((b, nc, g, n, rep, p), dtype=f32, device=xh.device)
    for c in range(nc):
        hprevs[:, c] = hprev.reshape(b, g, rep, n, p).transpose(2, 3)
        hprev = hprev * decay[:, c, :, None, None] + states[:, c]
    cg = cm.to(f32).reshape(b, nc, q, g, n).transpose(2, 3)  # (B,nc,G,Q,N)
    y_inter = cg @ hprevs.reshape(b, nc, g, n, rep * p)      # (B,nc,G,Q,rep·P)
    y_inter = y_inter.reshape(b, nc, g, q, rep, p) * torch.exp(
        cs.reshape(b, nc, g, rep, q).transpose(3, 4))[..., None]
    y_inter = y_inter.permute(0, 1, 3, 2, 4, 5).reshape(b, s, h, p)
    y = y_intra + y_inter.to(xh.dtype)
    return y, hprev.transpose(-1, -2).contiguous()


ssd_chunked.launches = 0


#: kernel name -> the wrapper that launches it
WRAPPERS = {"elastic_sgd_update": fused_elastic_update,
            "flash_attention_fwd": flash.flash_fwd,
            "flash_attention_fwd_tc": flash.flash_fwd_tc,
            "flash_attention_bwd_dkdv": flash.flash_bwd_dkdv,
            "flash_attention_bwd_delta": flash.flash_bwd_delta,
            "flash_attention_bwd_dkdv_tc": flash.flash_bwd_dkdv_tc,
            "flash_attention_bwd_dq": flash.flash_bwd_dq,
            "flash_attention_bwd_dq_tc": flash.flash_bwd_dq_tc,
            "ssd_chunk": ssd_chunked,
            "ssd_chunk_cuda_core": ssd_scan.ssd_chunk_cuda_core}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last `reset_launch_counts`."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
