"""Disaggregated prefill/decode serving over the shared SVA layer.

Production serving splits prefill (compute-bound, bursty) and decode
(memory-bound, steady) onto separate workers; the cost of the split is
moving each finished prompt's paged KV from the prefill worker's address
space to the decode worker's. This package models that hand-off the way
the paper's SVA argument says it should be modeled: as virtual-address
remote DMA through an IOMMU — the transfer's cost is per-page
TRANSLATION (PTW/IOTLB under the existing walk models) plus, only in the
copy baseline, the full KV payload. Under shared virtual addressing the
payload term vanishes (``share`` mode: refcount + table hand-off), which
is exactly the zero-copy-offload result at cross-worker scale.

Single-process model: both workers live in one engine over ONE
``PagePool``/``IOMMU`` namespace, partitioned by slot (ASID). See
:mod:`repro_torch.core.serving.disagg.engine` for the step pipeline and
ARCHITECTURE.md "Disaggregated serving" for the design notes.
"""
from repro_torch.core.serving.disagg.engine import DisaggEngine
from repro_torch.core.serving.disagg.workers import (DecodeWorker, KVTransferEngine,
                                               PrefillScheduler, PrefillWorker)

__all__ = ["DisaggEngine", "PrefillWorker", "DecodeWorker",
           "KVTransferEngine", "PrefillScheduler"]
