"""Plain float32 reference of DeepSeek-V2-Lite (arXiv:2405.04434; the
published ``deepseek-ai/DeepSeek-V2-Lite`` config.json beside this file as
``deepseek-v2-lite.json``), as one chip of the file's deployment holds it:
its layers, its experts and its slice of the vocabulary.

Every layer: RMSNorm, multi-head latent attention, a residual; RMSNorm, a
feed-forward block, a residual. After the last a final RMSNorm and an
untied head over the vocabulary slice. The loss is the per-token
cross-entropy of the next token, averaged with the elastic row weights
(`elastic_sgd`), plus the MoE layers' load-balance term.

* Attention (MLA, no query LoRA): q = h·Wq split per head into 128 + 64
  (rope) columns; [c | k_pe] = h·W_dkv, c ← RMSNorm(c); per head
  k_nope = c·W_uk and v = c·W_uv; rotate-half RoPE on q_pe and on the one
  k_pe every head shares, at YaRN's frequencies (`inv_freq`); scores
  scaled by 192^−½ · mscale² (`softmax_scale`), causal, softmax, the
  values, and W_o.
* Feed-forward: the first ``first_k_dense_replace`` layers a SwiGLU of
  width ``intermediate_size``. Then MoE: p = softmax(h·W_r) over all the
  router's experts, the top ``num_experts_per_tok`` picked greedily with
  weights p, not renormalised (``norm_topk_prob`` false); each expert keeps
  at most C = ⌈T·k/E·capacity_factor⌉ of a step's T tokens' assignments,
  in token order, and drops the rest. The output is the sum over the
  experts held here of w·SwiGLU(h), plus the shared experts' SwiGLU (one
  of width ``n_shared_experts · moe_intermediate_size``). The
  load-balance term is E·Σ_e f_e·p_e / k over the batch (f_e the share of
  tokens routed to e, p_e its mean probability), weighted by
  ``aux_loss_weight``.

Departures from the published model, and assumptions, are listed in the
configuration file (``departures``, ``assumed``): the rope layout
(rotate-half where it rotates interleaved pairs: a fixed permutation of
rope columns), the aux term's form, and the capacity.

The leaves, their shapes and their initial scales are listed by `leaves`,
the dense layers' as ``dense_layers.<group>.<name>.<l>`` and the MoE
layers' as ``layers.<group>.<name>.<l>``; the benchmark draws each from
its seed and hands the same to the program and to this reference.
`step_flops` counts the model's work for ``mfu``. MLA does not go through
K2, so there is no ``attention_shape``."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.reference.elastic_sgd import masked_mean
from bench.reference.precision import matmul


def sizes(conf: Dict) -> Dict:
    f = conf["moe_intermediate_size"]
    return {"d": conf["hidden_size"], "layers": conf["num_hidden_layers"],
            "dense": conf["first_k_dense_replace"],
            "h": conf["num_attention_heads"], "r": conf["kv_lora_rank"],
            "dn": conf["qk_nope_head_dim"], "dr": conf["qk_rope_head_dim"],
            "dv": conf["v_head_dim"], "f_dense": conf["intermediate_size"],
            "f": f, "f_shared": conf["n_shared_experts"] * f,
            "experts": conf["router_experts"],
            "held": conf["n_routed_experts"],
            "k": conf["num_experts_per_tok"], "vocab": conf["vocab_size"],
            "theta": conf["rope_theta"], "eps": conf["rms_norm_eps"],
            "aux_weight": conf["aux_loss_weight"],
            "capacity_factor": conf["capacity_factor"]}


def leaves(conf: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(path, shape, init, scale) of every leaf: ``normal`` leaves are
    N(0, scale²), the others ``ones``."""
    z = sizes(conf)
    d, h, r, v = z["d"], z["h"], z["r"], z["vocab"]
    dn, dr, dv = z["dn"], z["dr"], z["dv"]
    f, fd, fs = z["f"], z["f_dense"], z["f_shared"]
    attn = [("ln1", (d,), "ones", 1.0), ("ln2", (d,), "ones", 1.0),
            ("mla.wq", (d, h * (dn + dr)), "normal", d ** -0.5),
            ("mla.w_dkv", (d, r + dr), "normal", d ** -0.5),
            ("mla.ckv_norm", (r,), "ones", 1.0),
            ("mla.w_uk", (r, h, dn), "normal", r ** -0.5),
            ("mla.w_uv", (r, h, dv), "normal", r ** -0.5),
            ("mla.wo", (h * dv, d), "normal", (h * dv) ** -0.5)]
    dense = attn + [("mlp.w_gate", (d, fd), "normal", d ** -0.5),
                    ("mlp.w_up", (d, fd), "normal", d ** -0.5),
                    ("mlp.w_down", (fd, d), "normal", fd ** -0.5)]
    moe = attn + [("moe.router", (d, z["experts"]), "normal", d ** -0.5),
                  ("moe.w_in", (z["held"], d, 2 * f), "normal", d ** -0.5),
                  ("moe.w_out", (z["held"], f, d), "normal", f ** -0.5),
                  ("moe.w_sh_gate", (d, fs), "normal", d ** -0.5),
                  ("moe.w_sh_up", (d, fs), "normal", d ** -0.5),
                  ("moe.w_sh_down", (fs, d), "normal", fs ** -0.5)]
    out = [("embed", (v, d), "normal", 0.02)]
    for l in range(z["dense"]):
        out += [(f"dense_layers.{name}.{l}", shape, init, scale)
                for name, shape, init, scale in dense]
    for l in range(z["layers"] - z["dense"]):
        out += [(f"layers.{name}.{l}", shape, init, scale)
                for name, shape, init, scale in moe]
    out += [("ln_f", (d,), "ones", 1.0),
            ("lm_head", (d, v), "normal", d ** -0.5)]
    return out


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(conf: Dict) -> Tuple[int, int]:
    """(low, high): the rope dimensions (of qk_rope_head_dim / 2) between
    which YaRN's frequencies ramp from the plain to the interpolated ones:
    those that turn beta_fast and beta_slow times over the original
    context."""
    y, dim = conf["rope_scaling"], conf["qk_rope_head_dim"]
    base = conf["rope_theta"]

    def dims_at(rotations):
        return dim * math.log(y["original_max_position_embeddings"]
                              / (rotations * 2 * math.pi)) \
            / (2 * math.log(base))
    return (max(math.floor(dims_at(y["beta_fast"])), 0),
            min(math.ceil(dims_at(y["beta_slow"])), dim - 1))


def inv_freq(conf: Dict, device=None) -> torch.Tensor:
    """YaRN's rotary frequencies (qk_rope_head_dim / 2,): theta^(−2i/D)
    (``freq_extra``) and that over ``factor`` (``freq_inter``), mixed by a
    ramp from 0 at ``low`` to 1 at ``high``."""
    y, dim = conf["rope_scaling"], conf["qk_rope_head_dim"]
    low, high = yarn_range(conf)
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    extra = conf["rope_theta"] ** (-2 * i / dim)
    inter = extra / y["factor"]
    ramp = ((i - low) / max(high - low, 1e-3)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def mscale_squared(conf: Dict) -> float:
    """YaRN's mscale² on the softmax scale: (0.1 · mscale_all_dim ·
    ln(factor) + 1)². cos and sin are scaled by mscale / mscale_all_dim,
    which is 1 in the published config."""
    y = conf["rope_scaling"]
    if y["mscale"] != y["mscale_all_dim"]:
        raise ValueError("cos and sin scaled by mscale / mscale_all_dim "
                         "!= 1: not in this reference")
    return _yarn_mscale(y["factor"], y["mscale_all_dim"]) ** 2


def softmax_scale(conf: Dict) -> float:
    return (conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]) ** -0.5 \
        * mscale_squared(conf)


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, freqs):
    """x (B, S, H, D) at positions 0 … S-1, rotate-half, frequencies
    ``freqs`` (D/2,)."""
    s, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _swiglu(x, w_gate, w_up, w_down, precision):
    return matmul(torch.nn.functional.silu(matmul(x, w_gate, precision))
                  * matmul(x, w_up, precision), w_down, precision)


def _mla(h, p, z, freqs, scale, precision):
    b, s, _ = h.shape
    hh, r, dn, dr, dv = z["h"], z["r"], z["dn"], z["dr"], z["dv"]
    q = matmul(h, p("mla.wq"), precision).view(b, s, hh, dn + dr)
    q_nope, q_pe = q[..., :dn], _rope(q[..., dn:], freqs)
    ckv = matmul(h, p("mla.w_dkv"), precision)
    c = _rms(ckv[..., :r], p("mla.ckv_norm"), z["eps"])
    k_pe = _rope(ckv[..., r:].view(b, s, 1, dr), freqs)
    k_nope = matmul(c, p("mla.w_uk").reshape(r, hh * dn),
                    precision).view(b, s, hh, dn)
    v = matmul(c, p("mla.w_uv").reshape(r, hh * dv),
               precision).view(b, s, hh, dv)
    qh = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
    kh = torch.cat([k_nope, k_pe.expand(b, s, hh, dr)],
                   dim=-1).transpose(1, 2)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    sc = matmul(qh, kh.transpose(-1, -2), precision) * scale
    att = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = matmul(att, v.transpose(1, 2), precision).transpose(1, 2)
    return matmul(o.reshape(b, s, hh * dv), p("mla.wo"), precision)


def capacity(conf: Dict, tokens: int) -> int:
    """Assignments an expert keeps of a step's ``tokens`` tokens."""
    z = sizes(conf)
    return max(1, math.ceil(tokens * z["k"] / z["experts"]
                            * z["capacity_factor"]))


def route(conf: Dict, h2d: torch.Tensor, router: torch.Tensor,
          precision: str = "float32"):
    """(top-k probabilities (T, k), top-k experts (T, k), aux) of tokens
    h2d (T, d), softmax over the router's experts in float32."""
    z = sizes(conf)
    probs = torch.softmax(matmul(h2d, router, precision), dim=-1)
    topv, topi = torch.topk(probs, z["k"], dim=-1)
    share = torch.zeros_like(probs).scatter_(1, topi, 1.0).mean(0)
    aux = z["experts"] * torch.sum(share * probs.mean(0)) / z["k"]
    return topv, topi, aux


def moe_routed(conf: Dict, h2d: torch.Tensor, topv, topi, w_in, w_out,
               precision: str = "float32", experts=None):
    """Σ over the experts held, 0 … held − 1 (or those listed in
    ``experts``, by their router index, which also indexes ``w_in`` and
    ``w_out``), of each kept assignment's weight times the expert's SwiGLU,
    (T, d); and the number of assignments each dropped past capacity."""
    z = sizes(conf)
    cap = capacity(conf, h2d.shape[0])
    y = torch.zeros_like(h2d)
    dropped = []
    for e in experts if experts is not None else range(z["held"]):
        hit = topi == e                          # a token picks e at most once
        rows = torch.nonzero(hit.any(-1))[:, 0]  # token order
        dropped.append(max(len(rows) - cap, 0))
        rows = rows[:cap]
        w = (topv * hit).sum(-1)[rows]
        gate, up = matmul(h2d[rows], w_in[e], precision).chunk(2, dim=-1)
        out = matmul(torch.nn.functional.silu(gate) * up, w_out[e],
                     precision)
        y = y.index_add(0, rows, w[:, None] * out)
    return y, dropped


def _moe(h, p, conf, precision):
    b, s, d = h.shape
    h2d = h.reshape(b * s, d)
    topv, topi, aux = route(conf, h2d, p("moe.router"), precision)
    y, _ = moe_routed(conf, h2d, topv, topi, p("moe.w_in"), p("moe.w_out"),
                      precision)
    y = y + _swiglu(h2d, p("moe.w_sh_gate"), p("moe.w_sh_up"),
                    p("moe.w_sh_down"), precision)
    return y.view(b, s, d), aux


def loss(w: Dict[str, torch.Tensor], conf: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, weights: torch.Tensor,
         precision: str = "float32") -> torch.Tensor:
    """The weighted mean next-token loss of ``tokens`` (B, S) against
    ``labels`` (B, S), token weights ``weights`` (B, S), plus
    ``aux_loss_weight`` times the MoE layers' summed load-balance terms;
    exactly 0 where the weights sum to 0."""
    z = sizes(conf)
    freqs = inv_freq(conf, tokens.device)
    scale = softmax_scale(conf)
    x = w["embed"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    stacks = [("dense_layers", l) for l in range(z["dense"])] + \
        [("layers", l) for l in range(z["layers"] - z["dense"])]
    for stack, l in stacks:
        def p(name):
            return w[f"{stack}.{name}.{l}"]
        x = x + _mla(_rms(x, p("ln1"), z["eps"]), p, z, freqs, scale,
                     precision)
        h = _rms(x, p("ln2"), z["eps"])
        if stack == "dense_layers":
            x = x + _swiglu(h, p("mlp.w_gate"), p("mlp.w_up"),
                            p("mlp.w_down"), precision)
        else:
            y, a = _moe(h, p, conf, precision)
            x, aux = x + y, aux + a
    h = _rms(x, w["ln_f"], z["eps"])
    logits = matmul(h, w["lm_head"], precision)
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels[..., None])[..., 0]
    live = weights.sum() > 0
    return torch.where(live, masked_mean(nll, weights)
                       + z["aux_weight"] * aux, torch.zeros_like(aux))


def matmul_params(conf: Dict) -> float:
    """The matrix parameters a token uses: per layer MLA's five products
    (Wq, W_dkv, W_uk, W_uv, W_o); the dense layers' SwiGLU; per MoE layer
    the shared experts, the router, and k·held/E of one routed expert (the
    expected assignments to the experts held here); the head d·V. Not the
    embedding, which is a gather, nor the norms."""
    z = sizes(conf)
    d, h, r = z["d"], z["h"], z["r"]
    mla = d * h * (z["dn"] + z["dr"]) + d * (r + z["dr"]) \
        + r * h * (z["dn"] + z["dv"]) + h * z["dv"] * d
    moe = 3 * d * z["f_shared"] + d * z["experts"] \
        + z["k"] * z["held"] / z["experts"] * 3 * d * z["f"]
    return z["layers"] * mla + z["dense"] * 3 * d * z["f_dense"] \
        + (z["layers"] - z["dense"]) * moe + d * z["vocab"]


def step_flops(conf: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` rows of ``seq``
    positions, D = batch·seq tokens:

        6 · N · D  +  6 · L · H · (dq + dv) · batch · seq(seq+1)/2

    N being `matmul_params`; the second term is the causal attention's
    scores (dq = qk_nope + qk_rope) and values, forward (2 a pair and
    width) and backward (4). Expert slots that capacity leaves empty or
    drops are not counted, nor recomputation under remat."""
    z = sizes(conf)
    pairs = seq * (seq + 1) // 2
    return 6.0 * matmul_params(conf) * batch * seq + \
        6.0 * z["layers"] * z["h"] * (z["dn"] + z["dr"] + z["dv"]) \
        * batch * pairs
