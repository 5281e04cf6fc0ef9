"""Bytes that the raster's reduce kernel (`csrc/bev_counts.cu`,
`bev_raster_reduce`) must move at least: its three int32 inputs (row,
column and packed key of every padded point) read once, and its float32
(B, 3, H, W) raster written once. Its operations (a max and a count a
point) are far below the bytes' time, so the bound is the bytes over the
card's memory rate."""

from __future__ import annotations


def bytes_moved(batch: int, points: int, height: int, width: int) -> int:
    return batch * points * 3 * 4 + batch * 3 * height * width * 4
