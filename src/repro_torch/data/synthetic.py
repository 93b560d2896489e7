"""Synthetic data pipelines (the container has no datasets): Zipf token
streams for LM training, stub frame/patch embeddings for the audio/VLM
frontends, and a strongly-convex quadratic problem used to validate
Theorem 1 against its exact constants."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig


@dataclasses.dataclass
class TokenStream:
    """Deterministic, seekable synthetic LM data: Zipf-distributed tokens with
    a local bigram structure so the loss actually decreases under training."""

    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch(self, index: int, batch_size: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        base = rng.zipf(self.zipf_a, size=(batch_size, seq_len + 1))
        toks = np.minimum(base - 1, self.vocab_size - 1).astype(np.int32)
        # inject bigram structure: every even position repeats its neighbor
        toks[:, 1::2] = np.minimum(toks[:, 0:-1:2] + 1, self.vocab_size - 1)
        return toks


def lm_batch(cfg: ModelConfig, shape_bs: int, seq_len: int, index: int,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """Full input dict for one train step of any family."""
    stream = TokenStream(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng((seed, index, 1))
    if cfg.family == "vlm":
        text_len = seq_len - cfg.vision.num_patches
        assert text_len > 0, (
            f"seq_len={seq_len} must exceed the {cfg.vision.num_patches} "
            "patch tokens for a VLM batch")
        toks = stream.batch(index, shape_bs, text_len)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "patches": rng.normal(
                0, 0.5, (shape_bs, cfg.vision.num_patches, cfg.d_model)
            ).astype(np.float32),
        }
    elif cfg.family == "encdec":
        toks = stream.batch(index, shape_bs, seq_len)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "frames": rng.normal(
                0, 0.5, (shape_bs, cfg.encoder.src_len, cfg.d_model)
            ).astype(np.float32),
        }
    else:
        toks = stream.batch(index, shape_bs, seq_len)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return batch


# --------------------------------------------------------------------------
# Strongly convex quadratic (Theorem-1 oracle problem)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class QuadraticProblem:
    """G(w) = 1/(2|S|) Σ_s ||A_s w − b_s||² — c-strongly convex, L-smooth with
    exactly computable c, L, M, G*; per-sample gradients are unbiased with
    bounded variance, so the Theorem 1 constants are known, not estimated."""

    dim: int = 20
    n_samples: int = 512
    cond: float = 10.0
    noise: float = 1.0
    label_noise: float = 0.0      # >0 leaves gradient noise at the optimum
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # eigenvalues in [1, cond] -> c = 1, L = cond for the average Hessian
        eigs = np.linspace(1.0, self.cond, self.dim)
        q, _ = np.linalg.qr(rng.normal(size=(self.dim, self.dim)))
        h_sqrt = q @ np.diag(np.sqrt(eigs)) @ q.T
        self.A = np.stack([h_sqrt + self.noise * rng.normal(
            size=(self.dim, self.dim)) / np.sqrt(self.dim)
            for _ in range(self.n_samples)])
        self.w_star_gen = rng.normal(size=self.dim)
        self.b = np.einsum("sij,j->si", self.A, self.w_star_gen) \
            + self.label_noise * rng.normal(size=(self.n_samples, self.dim))
        self.H = np.einsum("sij,sik->jk", self.A, self.A) / self.n_samples
        ev = np.linalg.eigvalsh(self.H)
        self.c = float(ev.min())
        self.L = float(ev.max())
        self.w_star = np.linalg.solve(self.H, np.einsum(
            "sij,si->j", self.A, self.b) / self.n_samples)
        self.g_star = self.loss(self.w_star)

    def loss(self, w: np.ndarray) -> float:
        r = np.einsum("sij,j->si", self.A, w) - self.b
        return float(0.5 * np.mean(np.sum(r * r, axis=1)))

    def full_grad(self, w: np.ndarray) -> np.ndarray:
        """Exact ∇G(w) = H(w − w*) — the deterministic-gradient mode used
        for engine/legacy parity checks and throughput benchmarks."""
        return self.H @ (w - self.w_star)

    def error(self, w: np.ndarray) -> float:
        """G(w) − G* via the exact quadratic form (no residual pass)."""
        d = w - self.w_star
        return float(0.5 * d @ (self.H @ d))

    def grad_minibatch(self, w: np.ndarray, rng: np.random.Generator,
                       batch: int) -> np.ndarray:
        idx = rng.integers(0, self.n_samples, size=batch)
        a = self.A[idx]
        r = np.einsum("sij,j->si", a, w) - self.b[idx]
        return np.einsum("sij,si->j", a, r) / batch

    def grad_noise_bound(self, w_scale: float = 4.0, probes: int = 2000,
                         batch: int = 1) -> float:
        """Empirical M: sup E||g||² − ||∇G||² over a ball (Assumption 2)."""
        rng = np.random.default_rng(self.seed + 1)
        worst = 0.0
        for _ in range(probes // 50):
            w = self.w_star + rng.normal(size=self.dim) * w_scale
            full = np.einsum("jk,k->j", self.H, w) - np.einsum(
                "sij,si->j", self.A, self.b) / self.n_samples
            sq = 0.0
            for _ in range(50):
                g = self.grad_minibatch(w, rng, batch)
                sq += np.sum(g * g) / 50
            worst = max(worst, sq - np.sum(full * full))
        return worst
