"""Adam (Kingma & Ba 2015) with bias correction, no weight decay:
mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
p -= lr (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps)."""
from __future__ import annotations

import torch


class Adam:
    def __init__(self, params: dict, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.k = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.k += 1
        bc1, bc2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        for name, p in self.params.items():
            g = grads[name]
            self.mu[name].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[name].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p -= self.lr * (self.mu[name] / bc1) / (torch.sqrt(self.nu[name] / bc2) + self.eps)
