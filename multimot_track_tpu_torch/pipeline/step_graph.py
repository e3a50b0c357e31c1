"""The live pair step replayed from a recorded tape of CUDA graphs.

At B = 1, ``tracker.full_step`` enqueues about 12,000 small kernels a frame,
and the host's time to launch them, not the card's to run them, is the
step's time.  The step has the same shapes on every frame and reads nothing
back to the host, so one frame of it can be recorded and replayed.
``StepTape`` records it: each run of PyTorch operations between two cuts is
captured as a CUDA graph, every graph in one memory pool (where two cuts
meet, the graph between them is empty and replays as a no-op).  A cut falls

* at each flow-BA solve (``solve_flow_ba_auto``), which stays one host call
  a launch on every frame: a wrapper of ``flow_ba_cuda.solve_flow_ba_cuda``
  sees each call, with inputs that no later frame overwrites (copies of
  the graph-held ones) and outputs of its own, which the tape then copies
  to where the next graph reads them;
* at the entry and at the exit of each span of the step (``span``), so that
  ``dispatch_pair/ego`` and the others time their own graph launches and
  solves and carry their profiler ranges, as on an eager frame.

A replayed frame copies its inputs into the tape's, walks the tape (a graph
replayed, a span opened or closed, a solve called) and hands back copies of
the tape's outputs, which belong to the caller: no later frame overwrites
them.  The draws are the eager step's: every graph registers the sampler's
generator, and the noise generator where the step draws noise, so a replay
advances them by what the eager step would and reads the same offsets.

The tape engages only where the step is a pure function of its inputs on
the card: CUDA inputs and the ``MultinomialSampler`` drawing from a CUDA
generator (a sampler that names its draws reads the object slots back to
the host).  A signature is the inputs' shapes, dtypes and devices, the
config (which names the flow-BA route), the generators and the TF32
flags.  The first frame of a signature runs eagerly (it loads every kernel
the step launches), the second records the tape and replays it, and a new
signature drops the tape and starts again.  Everything else runs eagerly.

``span`` and ``solve_flow_ba_auto`` are the step's seams: outside a
recording they are ``profiling.span`` and ``flow_ba.solve_flow_ba_auto``.
"""

from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from multimot_track_tpu_torch.pipeline.frames import tree_leaves, tree_map
from multimot_track_tpu_torch.solvers import flow_ba, ransac
from multimot_track_tpu_torch.utils import profiling

# the recording running in this thread's context, if any
_RECORDING: contextvars.ContextVar = contextvars.ContextVar("mmt_step_recording", default=None)


def span(name: str):
    """A span of the step: ``profiling.span(name)``; while a step is
    recorded, a cut of the tape at its entry and at its exit."""
    rec = _RECORDING.get()
    return profiling.span(name) if rec is None else _SpanCut(rec, name)


def solve_flow_ba_auto(*args, **kwargs) -> flow_ba.FlowBAResult:
    """A flow-BA solve of the step: ``flow_ba.solve_flow_ba_auto``; while a
    step is recorded, a cut of the tape where the solve runs on replay."""
    rec = _RECORDING.get()
    if rec is None:
        return flow_ba.solve_flow_ba_auto(*args, **kwargs)
    return rec.solve(args, kwargs)


def _copy(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]):
    """``dst[i].copy_(src[i])`` for every i: one foreach copy a dtype."""
    groups = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _fresh(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Copies of ``tensors`` in memory of their own."""
    out = [torch.empty_like(t) for t in tensors]
    _copy(out, tensors)
    return out


def _generators(sampler, noise: Optional[torch.Generator],
                leaves: Sequence) -> Optional[Tuple[torch.Generator, ...]]:
    """The generators the step draws from, where the tape can replay the
    step: the sampler is a ``MultinomialSampler``, and the generators and
    every input are on the card.  None otherwise."""
    if type(sampler) is not ransac.MultinomialSampler:
        return None
    gens = (sampler.generator,) if noise is None else (sampler.generator, noise)
    if not all(g.device.type == "cuda" for g in gens):
        return None
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
        return None
    return gens


def _enter(name: str) -> Callable[[list], None]:
    def enter(spans: list):
        spans.append(profiling.span(name))
        spans[-1].__enter__()
    return enter


def _exit(spans: list):
    spans.pop().__exit__(None, None, None)


class _Solve:
    """A solve on the tape.  Its inputs are tensors the graphs write; on
    replay the solver gets copies of them and returns outputs of its own,
    which are copied into ``out``, the tensors the next graphs read."""

    def __init__(self, args: tuple, kwargs: dict, out: flow_ba.FlowBAResult):
        self.call, self.out = (args, kwargs), out
        self.inputs = [x for x in tree_leaves(self.call) if isinstance(x, torch.Tensor)]

    def __call__(self, spans: list):
        copies = iter(_fresh(self.inputs))
        args, kwargs = tree_map(lambda x: next(copies) if isinstance(x, torch.Tensor) else x,
                                self.call)
        _copy(self.out, flow_ba.solve_flow_ba_auto(*args, **kwargs))


class _SpanCut:
    """A span of the step while it is recorded: a cut at its entry and its
    exit (none when the recording fails inside it)."""

    def __init__(self, rec: "_Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec.cut(_enter(self.name))
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.rec.cut(_exit)
        return False


class _Recorder:
    """One recording of the step, on the capture stream.  A capture is open
    from the recording's start to its end but for the cuts: each ends the
    capture, puts its graph on the tape and the cut's entry after it, and
    begins the next capture."""

    def __init__(self, generators: Sequence[torch.Generator], stream: torch.cuda.Stream):
        self.generators, self.stream = generators, stream   # stream: the replays'
        self.pool = torch.cuda.graph_pool_handle()
        self.tape: list = []
        self.graph = None           # the open capture

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        # the capturing thread alone: the live system's prefetch thread
        # keeps uploading meanwhile
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self):
        graph, self.graph = self.graph, None
        with warnings.catch_warnings():
            # a cut right after a cut (a span's exit, the next one's entry)
            # captures nothing: that graph replays as a no-op
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            graph.capture_end()
        self.tape.append(lambda spans: graph.replay())

    def cut(self, entry: Callable[[list], None]):
        self.end()
        self.tape.append(entry)
        self.begin()

    def solve(self, args: tuple, kwargs: dict) -> flow_ba.FlowBAResult:
        self.end()
        obs = args[2]
        with torch.cuda.stream(self.stream):
            out = flow_ba.empty_result(obs.shape[0], obs.shape[1], obs.device)
        self.tape.append(_Solve(args, kwargs, out))
        self.begin()
        return out


class StepTape:
    """One live system's recorded pair step (the module's docstring): held
    by ``MultiMotSystem`` and passed to every ``tracker.full_step``."""

    def __init__(self):
        self._key = None          # the signature of the last eager frame, or of the tape
        self._tape = None         # the entries, once recorded
        self._inputs = self._outputs = self._out_tree = None
        self._stream = None       # the capture stream

    def run(self, step: Callable, inputs: tuple, sampler, noise: Optional[torch.Generator],
            cfg):
        """``step(*inputs)``'s outputs from the tape, recorded first on the
        second frame of a signature.  None where the step is to run eagerly:
        the tape does not engage, or this frame starts a signature."""
        leaves = tree_leaves(inputs)
        gens = _generators(sampler, noise, leaves)
        if gens is None:
            return None
        key = (cfg, torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32, gens,
               tuple((x.shape, x.dtype, x.device) for x in leaves))
        if key != self._key:
            self.__init__()
            self._key = key
            return None
        if self._tape is None:
            with torch.cuda.device(leaves[0].device):
                self._record(step, inputs, gens)
        _copy(self._inputs, leaves)
        spans: list = []
        for entry in self._tape:
            entry(spans)
        copies = iter(_fresh(self._outputs))
        return tree_map(lambda _: next(copies), self._out_tree)

    def _record(self, step: Callable, inputs: tuple, gens):
        """Run ``step`` once under capture on the tape's inputs (copies of
        ``inputs``), on the current device; nothing runs on the card until
        the tape is replayed."""
        static = tree_map(torch.clone, inputs)
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        rec = _Recorder(gens, torch.cuda.current_stream())
        token = _RECORDING.set(rec)
        try:
            with torch.cuda.stream(self._stream):
                rec.begin()
                out = step(*static)
                rec.end()
        except BaseException:
            if rec.graph is not None:
                with contextlib.suppress(RuntimeError):     # end a capture left open
                    rec.graph.capture_end()
            self.__init__()
            raise
        finally:
            _RECORDING.reset(token)
        self._tape, self._inputs = rec.tape, tree_leaves(static)
        self._out_tree, self._outputs = out, tree_leaves(out)
