"""GAN losses and the R1 gradient penalty (port of ``gmpi_tpu/train/losses.py``).

Non-saturating softplus losses.  R1 is the squared L2 norm of ``dD/d(real
image)``, taken with ``torch.autograd.grad(create_graph=True)`` so that the
penalty itself differentiates with respect to D's parameters; the port's ops
are plain PyTorch, so that double backward comes from autograd.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def d_gan_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discriminator loss pair ``(loss_real, loss_fake)``."""
    return F.softplus(-real_scores).mean(), F.softplus(fake_scores).mean()


def g_gan_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """Generator non-saturating loss."""
    return F.softplus(-fake_scores).mean()


def r1_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor], real_imgs: torch.Tensor,
               r1_lambda: float) -> torch.Tensor:
    """``0.5 * lambda * mean_b ||d sum(D)/d x_b||^2``, differentiable with
    respect to the parameters ``d_apply`` closes over."""
    imgs = real_imgs.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(d_apply(imgs).sum(), imgs, create_graph=True)
    return 0.5 * r1_lambda * grad.square().flatten(1).sum(dim=1).mean()
