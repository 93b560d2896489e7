"""K2's share of its roofline (%): the least time the card could take for
every launch of flash attention's four bf16 kernels in the window (the
forward, the backward's D_i pre-pass, dK/dV and dQ; a remat's second
forward included), over the device time the trace gives them.

Work of one launch at B rows, S positions, Hq query and Hkv key/value
heads of width D (the model's head width, not the width a kernel pads it
to), causal, with P = S(S+1)/2 valid pairs and 2-byte elements:

    forward   4·B·Hq·D·P FLOP;  reads q, k, v, writes o and the lse
    D_i       2·B·Hq·S·D FLOP;  reads o and dO, writes D_i
    dK/dV     8·B·Hq·D·P FLOP;  reads q, dO, lse, D_i, k, v; writes dk, dv
    dQ        6·B·Hq·D·P FLOP;  reads q, dO, lse, D_i, k, v; writes dq

with q-sized tensors B·S·Hq·D·2 bytes, k/v-sized B·S·Hkv·D·2 and the lse
and D_i B·Hq·S·4. Its least time is the larger of FLOP over the bf16 peak
and bytes over the HBM rate. The shape of a launch is the configuration
reference's ``attention_shape`` at the traffic's batch and ``seq_len − 1``
positions."""

KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_delta_kernel",
           "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")


def work(kernel: str, b: int, s: int, hq: int, hkv: int, d: int):
    """(FLOP, bytes) of one launch."""
    pairs = s * (s + 1) // 2
    q, kv, lse = b * s * hq * d * 2, b * s * hkv * d * 2, b * hq * s * 4
    return {"flash_fwd_tc_kernel": (4 * b * hq * d * pairs,
                                    2 * q + 2 * kv + lse),
            "flash_bwd_delta_kernel": (2 * b * hq * s * d, 2 * q + lse),
            "flash_bwd_dkdv_tc_kernel": (8 * b * hq * d * pairs,
                                         2 * q + 4 * kv + 2 * lse),
            "flash_bwd_dq_tc_kernel": (6 * b * hq * d * pairs,
                                       3 * q + 2 * kv + 2 * lse)}[kernel]


def bound_s(kernel, b, s, hq, hkv, d, peaks) -> float:
    flops, nbytes = work(kernel, b, s, hq, hkv, d)
    return max(flops / peaks.bfloat16, nbytes / peaks.hbm_bytes_per_s)


def read(facts):
    peaks, ref, t = facts.get("peaks"), facts["reference"], facts["traffic"]
    if peaks is None or not hasattr(ref, "attention_shape"):
        return None
    shape = ref.attention_shape(facts["conf"], t["batch"], t["seq_len"] - 1)
    least = dev_s = 0.0
    for name, (n, secs) in (facts.get("kernels") or {}).items():
        for k in KERNELS:
            if k in name:
                least += n * bound_s(k, *shape, peaks)
                dev_s += secs
    return None if dev_s == 0 else 100.0 * least / dev_s
