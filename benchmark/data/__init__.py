"""Inputs drawn on the card from the seed. A table's spec names its
distribution, ``data/<dist>.py``, whose ``draw(spec, generator, device)``
returns it; a new distribution is a new file."""

from __future__ import annotations

import importlib

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (a seed may
    pass 32 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**64)
    return g


def draw(spec: dict, g: torch.Generator, device: torch.device) -> torch.Tensor:
    """The (columns, rows) table that ``spec`` describes."""
    return importlib.import_module(f"benchmark.data.{spec['dist']}").draw(
        spec, g, device)


def one_table(config: dict, seed: int, device: torch.device) -> dict:
    """The inputs of a kind whose queries read ranges of the configuration's
    ``table`` alone."""
    return {"table": draw(config["table"], generator(seed, device), device)}


def table_range(inputs: dict, query) -> tuple:
    """The call's arguments for ``(column, offset, rows)``: that range of
    the table, a view."""
    col, off, n = query
    return (inputs["table"][col, off:off + n],)
