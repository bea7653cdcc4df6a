"""TrainLoop — the Run() loop of the SPMD apps.

Threads together the pieces the reference scatters across Engine::Run and
the app UDF (SURVEY.md §3.2-3.3): data iteration, the fused step, JSONL
metrics with samples/sec (the [T1] primary metric), optional periodic
checkpointing, and the consistency clock (for observability; on the pure
SPMD path BSP is implicit in the collectives).

The port of ``minips_tpu/train/loop.py``: the same loop, with the batch
walked by the port's tree utilities. ``profile_dir`` captures a
``torch.profiler`` trace of the steps in ``profile_range``
(``utils/profiling.py``); ``python -m minips_tpu_torch.utils.trace_analysis
<profile_dir>`` turns it into an op table.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from minips_tpu_torch.utils.metrics import MetricsLogger
from minips_tpu_torch.utils.profiling import StepWindowProfiler
from minips_tpu_torch.utils.timing import StepTimer
from minips_tpu_torch.utils.tree import tree_leaves


class TrainLoop:
    def __init__(
        self,
        step: Callable[[Any], Any],
        data: Iterable[Any],
        *,
        metrics: Optional[MetricsLogger] = None,
        log_every: int = 10,
        batch_size: Optional[int] = None,
        checkpointer=None,
        checkpoint_every: int = 0,
        warmup_steps: int = 2,
        step_offset: int = 0,
        profile_dir: Optional[str] = None,
        profile_range: tuple[int, int] = (10, 13),
        prefetch: Optional[Callable[[Any], None]] = None,
        extra_metrics: Optional[Callable[[], dict]] = None,
    ):
        self.step = step
        self.data = data
        # ``prefetch(next_batch)`` is called with batch t+1 BEFORE
        # ``step(batch t)`` runs — the overlap hook for PS-backed steps:
        # a sharded-PS app passes a callable that starts
        # ``table.prefetch_pull(keys_of(next_batch))`` so the pull round
        # trip rides under this step's compute (train/sharded_ps.py
        # pipeline). Costs one batch of lookahead in the data stream;
        # None (the default) keeps the loop strictly sequential.
        self.prefetch = prefetch
        # ``extra_metrics()`` is splatted into every periodic log line —
        # the hook PS-backed loops use to surface wire/cache health
        # (``utils.metrics.wire_record``: bytes both ways, per-leg
        # timing, row-cache hit rate) next to loss without the loop
        # knowing what a trainer is. Keep it cheap: it runs every
        # ``log_every`` steps on the training thread.
        self.extra_metrics = extra_metrics
        self.metrics = metrics or MetricsLogger(verbose=False)
        self.log_every = log_every
        self.batch_size = batch_size
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        # Global step numbering continues across resumes: without the
        # offset, a resumed run would re-save low step numbers and a later
        # restore() would pick an old-numbered-but-newer checkpoint.
        self.step_offset = step_offset
        self.timer = StepTimer(warmup_steps=warmup_steps)
        self.profiler = None
        if profile_dir:
            self.profiler = StepWindowProfiler(profile_dir, *profile_range)

    def run(self, num_iters: int) -> list[float]:
        try:
            return self._run(num_iters)
        finally:
            if self.profiler is not None:
                self.profiler.close()  # an open trace must flush even on error

    def _run(self, num_iters: int) -> list[float]:
        losses: list[float] = []
        # Resume continues the data stream, not just the step numbering: a
        # data source with iter_from (BatchIterator) is fast-forwarded to
        # the global step so a resumed run sees exactly the batches the
        # uninterrupted run would have seen from there.
        if self.step_offset and hasattr(self.data, "iter_from"):
            it = self.data.iter_from(self.step_offset)
        else:
            if self.step_offset:
                # e.g. a bare generator: we cannot fast-forward it, so the
                # exact-replay-on-resume guarantee is the caller's problem
                self.metrics.log(
                    warning="resume: data source has no iter_from; stream "
                            "starts wherever the caller left it")
            it = iter(self.data)
        ahead = None  # batch t+1, already announced through prefetch
        for i in range(num_iters):
            if self.profiler is not None:
                self.profiler.on_step(i)
            if ahead is not None:
                batch, ahead = ahead, None
            else:
                try:
                    batch = next(it)
                except StopIteration:
                    # finite sources (one-pass streams) end the loop
                    # cleanly; BatchIterator-style sources cycle and
                    # never raise
                    self.metrics.log(event="stream_exhausted",
                                     step=self.step_offset + i)
                    break
            if self.prefetch is not None:
                # announce batch t+1 before stepping batch t, so a
                # PS-backed step's pull round trip overlaps this step's
                # compute; a batch prefetched but never stepped (the
                # num_iters bound lands between them) is the callback
                # owner's cleanup (PullFuture.cancel)
                try:
                    ahead = next(it)
                except StopIteration:
                    ahead = None
                else:
                    self.prefetch(ahead)
            loss = self.step(batch)
            n = (self.batch_size if self.batch_size is not None
                 else _leading_dim(batch))
            self.timer.step(n)
            losses.append(float(loss))
            gstep = self.step_offset + i + 1
            if self.log_every and (i + 1) % self.log_every == 0:
                extra = (self.extra_metrics()
                         if self.extra_metrics is not None else {})
                self.metrics.log(step=gstep, loss=float(loss),
                                 samples_per_sec=self.timer.samples_per_sec,
                                 **extra)
            # GLOBAL-step modulo: a resumed run keeps the same checkpoint
            # cadence as an uninterrupted one (local modulo would drift by
            # start_step and can leave resumed tail steps never saved)
            if (self.checkpointer is not None and self.checkpoint_every
                    and gstep % self.checkpoint_every == 0):
                self.checkpointer.save(step=gstep)
        return losses


def _leading_dim(batch) -> int:
    leaves = tree_leaves(batch)
    return int(leaves[0].shape[0]) if leaves else 0
