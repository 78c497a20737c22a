"""Dwarf registry: name → instance singleton map.

Reference: common/registry.{hpp,cpp} — ``Registry::instance()``,
``registerd(Dwarf*)``, ``find(name)``, iteration for the ``list`` subcommand.
Registration happens in ``dwarf_bench_tpu_torch.dwarfs.populate_registry`` (the
equivalent of register_dwarfs.cpp:20-56).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from .dwarf import Dwarf


class Registry:
    _instance: Optional["Registry"] = None

    def __init__(self) -> None:
        self._dwarfs: Dict[str, Dwarf] = {}
        self._root_path: str = ""

    @classmethod
    def instance(cls) -> "Registry":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Testing hook: drop the singleton so registration can rerun."""
        cls._instance = None

    def registerd(self, dwarf: Dwarf) -> None:
        # Reference keeps the first registration on name conflict
        # (std::map emplace semantics, registry.cpp:10-14).
        self._dwarfs.setdefault(dwarf.name, dwarf)

    def find(self, name: str) -> Optional[Dwarf]:
        return self._dwarfs.get(name)

    def set_root(self, root: str) -> None:
        self._root_path = root

    def __iter__(self) -> Iterator[Tuple[str, Dwarf]]:
        # std::map iteration order is sorted by key.
        return iter(sorted(self._dwarfs.items()))

    def __len__(self) -> int:
        return len(self._dwarfs)
