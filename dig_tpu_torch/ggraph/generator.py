"""Generator ABC — the uniform 3-task contract every ggraph method
implements (reference ``dig/ggraph/method/generator.py:1-52``)."""
from __future__ import annotations

from abc import ABC


class Generator(ABC):
    r"""Tasks: random generation, property optimization, constrained
    property optimization. Subclasses override the pairs they support."""

    def train_rand_gen(self, loader, *args, **kwargs):
        raise NotImplementedError

    def run_rand_gen(self, *args, **kwargs):
        raise NotImplementedError

    def train_prop_opt(self, *args, **kwargs):
        raise NotImplementedError

    def run_prop_opt(self, *args, **kwargs):
        raise NotImplementedError

    def train_const_prop_opt(self, loader, *args, **kwargs):
        raise NotImplementedError

    def run_const_prop_opt(self, *args, **kwargs):
        raise NotImplementedError
