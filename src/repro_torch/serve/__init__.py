"""FALKON serving layer: a batch-coalescing predict server.

    from repro_torch.serve import CoalescingPredictServer
    server = CoalescingPredictServer(est, max_batch=256)
    server.warmup()                       # one CUDA graph per bucket rung
    preds = server.predict_many(batches)  # ragged batches, no capture after warmup

``coalesce`` holds the packing policy (bucket ladder, dispatch planning);
``server`` executes it over ``KernelOps.apply`` (on the card B2, replayed
from captured graphs), including the stacked tier that serves a whole
``FalkonPathResult``. ``python -m repro_torch.launch.serve --falkon`` drives
it from the command line.
"""
from .coalesce import Dispatch, Segment, bucket_ladder, pick_bucket, plan_dispatches
from .server import CoalescingPredictServer, ServeStats

__all__ = [
    "CoalescingPredictServer",
    "Dispatch",
    "Segment",
    "ServeStats",
    "bucket_ladder",
    "pick_bucket",
    "plan_dispatches",
]
