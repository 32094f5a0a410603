"""Client/server decode steps for the streaming runtime.

The decode caches are stacked per layer and the cut splits the layer axis:
the client (feature owner) writes layers [0, cut), the server (label owner)
layers [cut, L) — each party touches only its own range, in place.

  * bottom step (client): embed -> layers [0, cut) -> the device codec,
    one fused launch of selection, encode and bit-pack on the card
    (`split.protocol.client_encode_device`); or, with the host codec
    (`make_bottom_step`), the payload pulled to the host for
    `wire.encode_payload_frame`.
  * arena top step (server): the cut rows of `xbuf` -> layers [cut, L) ->
    LM head -> greedy token, over the WHOLE arena with fixed shapes (rows
    are independent, so a row's numbers do not depend on which other rows
    are active); only the active rows' KV and positions are written.
  * fused decode step: the flush payload decoded into `xbuf[slots]`, then
    the arena top step — one call per single-meta flush.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import compressors
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.split import protocol


def bottom_hidden(params, cfg: ArchConfig, cut: int, cache, token):
    """Client half of the model: token (1, 1) -> cut activation (1, 1, d);
    writes layers [0, cut) of `cache` and advances its position."""
    dev = cache["pos"].device
    tok = torch.as_tensor(np.asarray(token), device=dev).reshape(1, 1)
    x = transformer.embed(params, cfg, tok)
    x = transformer.decode_layers(params, cfg, x, cache, 0, cut)
    cache["pos"] += 1
    return x


def make_bottom_step_device(cfg: ArchConfig, cut: int,
                            comp: compressors.Compressor) -> Callable:
    """(params, cache, token (1,1) i32) -> (Payload, sections): the device
    Payload (meta and batch shape for the frame subheader) and its packed
    wire sections. Inference-mode encode (RandTopK -> TopK)."""

    def bottom_step(params, cache, token):
        x = bottom_hidden(params, cfg, cut, cache, token)
        return protocol.client_encode_device(comp, x, training=False)

    return bottom_step


def make_bottom_step(cfg: ArchConfig, cut: int,
                     comp: compressors.Compressor) -> Callable:
    """(params, cache, token (1,1) i32) -> the host Payload (numpy leaves
    in the wire dtypes) for the host codec. Inference-mode encode."""

    def bottom_step(params, cache, token):
        x = bottom_hidden(params, cfg, cut, cache, token)
        return protocol.client_encode(comp, x, training=False)

    return bottom_step


def top_logits(params, cfg: ArchConfig, cut: int, xbuf, cache, rows):
    """Layers [cut, L) + LM head over every arena row; writes the KV of the
    `rows` (index vector) in place. Returns logits (C, 1, V)."""
    C = cache["pos"].shape[0]
    x = xbuf[:C].reshape(C, 1, cfg.d_model)
    x = transformer.decode_layers(params, cfg, x, cache, cut, cfg.n_layers,
                                  rows)
    return transformer.lm_head(params, cfg, x)


def make_arena_top_step(cfg: ArchConfig, cut: int) -> Callable:
    """(params, xbuf (C+1, 1, 1, d), cache (C rows), active (C,) numpy
    bool) -> tokens (C,) int32 on the device. Inactive slots compute and
    discard: their KV and position are never written."""

    def arena_step(params, xbuf, cache, active):
        dev = cache["pos"].device
        rows = torch.as_tensor(np.flatnonzero(active), device=dev)
        logits = top_logits(params, cfg, cut, xbuf, cache, rows)
        cache["pos"][rows] += 1
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    return arena_step


def make_fused_decode_step(top_step: Callable, *, backend=None) -> Callable:
    """(params, xbuf, payload, slots, cache, active) -> tokens: decode the
    stacked flush payload into `xbuf[slots]` (the decode kernel, or its
    plain version per `backend`), then the arena step."""

    def fused_step(params, xbuf, payload, slots, cache, active):
        protocol.server_decode_to_slots(xbuf, payload, slots,
                                        backend=backend)
        return top_step(params, xbuf, cache, active)

    return fused_step
