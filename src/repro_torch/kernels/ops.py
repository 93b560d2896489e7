"""Public wrappers around the hand-written kernels.

Each wrapper dispatches on the device of its tensors: a CUDA tensor goes
to the kernel (or the call raises), a CPU tensor goes to the plain PyTorch
version in ``kernels.ref``. Each keeps a count of its kernel launches, so
a run can show that its main path went through the kernel."""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref
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
    fused_elastic_update.launches += 1
    return params, mom


fused_elastic_update.launches = 0


def flash_mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0):
    """Model-layout attention: q (B, S, H, D), k/v (B, T, Hkv, D) ->
    (B, S, H, D), differentiable.

    On CUDA tensors this runs K2 (``kernels.flash_attention``): the forward
    kernel, and the two backward kernels as its gradient, each counting its
    launches. The kernels read the model's layout through transposed views,
    and the output and gradients come back in it, so nothing is copied. On
    CPU tensors it runs ``ref.mha_reference`` under autograd."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.device.type == "cpu":
        out = ref.mha_reference(qt, kt, vt, causal=causal, window=window,
                                q_offset=q_offset)
    else:
        out = flash.flash_attention(qt, kt, vt, causal=causal,
                                    window=window, q_offset=q_offset)
    return out.transpose(1, 2)


#: kernel name -> the wrapper that launches it
WRAPPERS = {"elastic_sgd_update": fused_elastic_update,
            "flash_attention_fwd": flash.flash_fwd,
            "flash_attention_bwd_dkdv": flash.flash_bwd_dkdv,
            "flash_attention_bwd_dq": flash.flash_bwd_dq}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last `reset_launch_counts`."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
