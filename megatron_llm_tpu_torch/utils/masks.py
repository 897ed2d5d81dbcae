"""Mask and position-id construction (port of utils/masks.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def get_document_starts(tokens: torch.Tensor, eod_token: int) -> torch.Tensor:
    """(b, s) int32: for each position, the index of its document's first
    token (the eod token belongs to its document; JAX :12-26)."""
    b, s = tokens.shape
    is_eod = (tokens == eod_token).int()
    idx = torch.arange(s, device=tokens.device)[None, :]
    prev = torch.nn.functional.pad(is_eod[:, :-1], (1, 0))
    boundary = torch.where(prev == 1, idx, torch.zeros_like(idx))
    return torch.cummax(boundary, dim=1).values.int()


def get_ltor_masks_and_position_ids(
    tokens: torch.Tensor,
    eod_token: Optional[int] = None,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(attention_mask, loss_mask, position_ids), JAX :29-87.

    attention_mask is (b, 1, s, s) bool, True = masked out, or None
    whenever the mask is plain causal (`reset_attention_mask=False`):
    None keeps the flash path eligible. loss_mask is (b, s) fp32 and
    position_ids (b, s) int64."""
    b, s = tokens.shape
    dev = tokens.device
    loss_mask = torch.ones(b, s, dtype=torch.float32, device=dev)
    if eod_mask_loss and eod_token is not None:
        loss_mask = torch.where(tokens == eod_token,
                                torch.zeros_like(loss_mask), loss_mask)
    idx = torch.arange(s, device=dev)[None, :]
    if not (reset_position_ids or reset_attention_mask):
        return None, loss_mask, idx.expand(b, s).clone()

    assert eod_token is not None
    is_eod = (tokens == eod_token).long()
    doc_id = torch.cumsum(is_eod, dim=1) - is_eod
    if reset_position_ids:
        position_ids = idx - get_document_starts(tokens, eod_token).long()
    else:
        position_ids = idx.expand(b, s).clone()
    if reset_attention_mask:
        causal = idx > idx.T  # (s, s): cols > rows
        same_doc = doc_id[:, :, None] == doc_id[:, None, :]
        return ((~same_doc) | causal[None])[:, None], loss_mask, position_ids
    return None, loss_mask, position_ids
