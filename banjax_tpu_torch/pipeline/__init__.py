"""Streaming pipeline scheduler (a port of `banjax_tpu/pipeline/`).

The subsystem between the log tailer and the matcher: the synchronous
per-batch consume becomes overlapped encode, device and drain stages,
with adaptive batch sizing, bounded backpressure and staleness
accounting. See pipeline/scheduler.py for the stage and ordering
contract and pipeline/sizer.py for the batch sizing policy.
"""

from banjax_tpu_torch.pipeline.scheduler import PipelineScheduler
from banjax_tpu_torch.pipeline.sizer import AdaptiveBatchSizer

__all__ = ["PipelineScheduler", "AdaptiveBatchSizer"]
