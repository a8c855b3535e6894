"""Centered orthonormal DFTs and the per-frame masked normal kernel, in complex64."""

from __future__ import annotations

import torch

__all__ = ["fft1c", "ifft1c", "ifft2c", "fft2c", "dft_matrix", "normal_kernel"]


def fft1c(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fftshift ∘ FFT ∘ ifftshift`` along ``dim``, orthonormal."""
    y = torch.fft.fft(torch.fft.ifftshift(x, dim=dim), dim=dim, norm="ortho")
    return torch.fft.fftshift(y, dim=dim)


def ifft1c(x: torch.Tensor, dim: int) -> torch.Tensor:
    y = torch.fft.ifft(torch.fft.ifftshift(x, dim=dim), dim=dim, norm="ortho")
    return torch.fft.fftshift(y, dim=dim)


def fft2c(x: torch.Tensor) -> torch.Tensor:
    dims = (-2, -1)
    y = torch.fft.fft2(torch.fft.ifftshift(x, dim=dims), norm="ortho")
    return torch.fft.fftshift(y, dim=dims)


def ifft2c(x: torch.Tensor) -> torch.Tensor:
    dims = (-2, -1)
    y = torch.fft.ifft2(torch.fft.ifftshift(x, dim=dims), norm="ortho")
    return torch.fft.fftshift(y, dim=dims)


def dft_matrix(n: int, inverse: bool, device, dtype=torch.complex64) -> torch.Tensor:
    """The centered DFT of length ``n`` as an ``n x n`` matrix of ``dtype``
    (columns are the transforms of the unit vectors), built in complex128."""
    eye = torch.eye(n, dtype=torch.complex128, device=device)
    m = ifft1c(eye, 0) if inverse else fft1c(eye, 0)
    return m.to(dtype)


def normal_kernel(mask: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """``T = F⁻¹ diag(m) F`` along h for each (batch, frame) of a line mask
    ``(b, t, 1, h, 1)``: ``(b, t, h, h)`` of ``dtype``. For a line mask the
    w-axis transform cancels in ``Aᴴ M A``."""
    h = mask.shape[3]
    wf = dft_matrix(h, False, mask.device, dtype)
    wi = dft_matrix(h, True, mask.device, dtype)
    m = mask[:, :, 0, :, 0].to(dtype)  # (b, t, h)
    return wi @ (m[..., :, None] * wf)
