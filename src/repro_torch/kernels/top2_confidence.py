"""MaxDiff confidence: the top-2 margin of each row, on the card.

Replaces ``repro/kernels/top2_confidence.py::_top2_kernel`` (Pallas TPU).
CUDA source: ``csrc/fog_kernels.cu``, two launches chosen by the row
length ``C`` and the batch ``B`` (:func:`row_blocks`, a rule on the shape
alone):

* ``C <= SHORT_ROW`` (the forest's ``[B, 10]`` rows):
  ``top2_confidence_kernel``, one thread per row: it finds the first
  maximum, then the maximum over the other entries.
* longer rows (the LM gate's ``[4, 32000]`` and ``[4, 50280]``):
  ``top2_confidence_kernel_rows``, ``nblk`` blocks of 256 threads per row,
  each thread keeping the top two of its stride with the first index of
  its maximum, merged by warp shuffles and across warps; with ``nblk > 1``
  ``top2_confidence_kernel_merge`` merges the ``[B, nblk]`` partials (one
  warp per row).

Both write ``|m1 - m2|`` with only the first maximal entry masked, and
round nothing but that difference, so they equal the plain version
:func:`top2_confidence_ref` bit for bit.  Either is bound by the
``[B, C]`` bytes it reads; a call counts one launch, both passes
included.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import top2_confidence_ref

__all__ = ["top2_confidence_cuda", "top2_confidence_ref", "row_blocks"]

# rows up to this long are walked by one thread each
SHORT_ROW = 64
# columns one 256-thread block of the long-row kernel takes at most (8 a
# thread), and the blocks that fill the card (two per SM on 132 SMs)
COLS_PER_BLOCK = 2048
FILL_BLOCKS = 264


def row_blocks(B: int, C: int) -> int:
    """Blocks per row of the launch that takes ``[B, C]``: 0 for one thread
    per row (``C <= SHORT_ROW``), else enough blocks to fill the card when
    B is small, no more than one per ``COLS_PER_BLOCK`` columns, at least
    one."""
    if C <= SHORT_ROW:
        return 0
    return max(1, min(-(-C // COLS_PER_BLOCK), -(-FILL_BLOCKS // B)))


def top2_confidence_cuda(prob: torch.Tensor, *,
                         block_b: int = 256) -> torch.Tensor:
    """[B, C] float32 CUDA tensor -> [B] margins (one counted launch;
    ``block_b`` is the threads per block of the one-thread-per-row
    kernel)."""
    _build.check_cuda("prob", prob, torch.float32, 2)
    _build.check_block(block_b)
    B, C = prob.shape
    out = torch.empty((B,), dtype=torch.float32, device=prob.device)
    if B and C:
        nblk = row_blocks(B, C)
        scratch = (torch.empty((3 * B * nblk,), dtype=torch.float32,
                               device=prob.device) if nblk > 1 else out)
        _build.launch("top2_confidence", prob.device, prob.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), B, C, block_b,
                      nblk)
    return out
