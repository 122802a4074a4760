"""Abstract QC method interface.

Parity with the reference's `qc_method_t`
(mqc_method_base.f90:13-60): energy, gradient,
Hessian entry points per fragment — here batch-first (lists in, arrays out).
"""

from __future__ import annotations

import abc


class QCMethod(abc.ABC):
    """Batch-first method API consumed by the FragmentExecutor."""

    variant: str = "none"

    @abc.abstractmethod
    def make_batch(self, fragments, pad_to=None):
        """Host-side padded batch from fragment tuples/objects."""

    @abc.abstractmethod
    def energies(self, batch):
        """(B,) energies + aux dict."""

    @abc.abstractmethod
    def gradients(self, batch):
        """(B,) energies, (B, nat, 3) gradients, aux dict."""
