"""Deterministic sharded synthetic data pipeline (the JAX package's, in its
own copy: the same numpy draws give the same batch for the same ``(seed,
step, dp_rank)``, byte for byte).

Production properties the trainer depends on:
  * **determinism & restorability** — batch at step t is a pure function of
    (seed, step, dp_rank); the iterator state is just the step counter, saved
    inside every checkpoint, so restarts resume mid-epoch exactly;
  * **sharding** — each dp rank generates only its local slice of the
    global batch;
  * **host prefetch** — a background thread keeps ``prefetch`` batches ready
    so the accelerator never waits on generation (overlap compute/host);
  * **frontend stubs** — audio frames / VLM patch embeddings are generated to
    the model's ``batch_specs`` (the assignment's stub-frontend contract).

Synthetic text follows a Zipf-ish distribution with induced bigram structure
so cross-entropy actually decreases during the example runs (pure uniform
tokens would pin loss at ln V).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models import Model, ShapeSpec


@dataclasses.dataclass
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2
    #: batches kept ready by the prefetch thread
    prefetch: int = 2


class SyntheticPipeline:
    """Iterator of host numpy batches for (model, shape, dp shard)."""

    def __init__(
        self,
        model: Model,
        shape: ShapeSpec,
        cfg: Optional[DataConfig] = None,
        dp_rank: int = 0,
        dp_size: int = 1,
        start_step: int = 0,
    ):
        self.model = model
        self.shape = shape
        self.cfg = cfg or DataConfig()
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.step = start_step
        self.specs = model.batch_specs(shape)
        if shape.global_batch % dp_size:
            raise ValueError(f"global_batch {shape.global_batch} % dp {dp_size} != 0")
        self.local_batch = shape.global_batch // dp_size
        # Zipf-ish unigram table over the real vocab
        V = model.cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = ranks ** (-self.cfg.zipf_a)
        self._probs = p / p.sum()
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- deterministic generation ------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.dp_rank])
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        V = self.model.cfg.vocab_size
        out: Dict[str, np.ndarray] = {}
        for name, spec in self.specs.items():
            shape = (self.local_batch,) + spec.shape[1:]
            if spec.dtype == "int32":
                toks = rng.choice(V, size=shape, p=self._probs).astype(np.int32)
                if name == "tokens" and len(shape) == 2 and shape[1] > 1:
                    # induce learnable bigram structure: even positions repeat
                    toks[:, 1::2] = (toks[:, 0::2][:, : toks[:, 1::2].shape[1]] + 1) % V
                out[name] = toks
            else:
                out[name] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if "labels" in self.specs:
            out["labels"] = np.roll(out["tokens"], -1, axis=1)
        return out

    # -- iterator protocol w/ prefetch ---------------------------------------------
    def _worker(self):
        assert self._q is not None
        step = self.step
        while not self._stop.is_set():
            b = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self) -> "SyntheticPipeline":
        self._q = queue.Queue(maxsize=self.cfg.prefetch)
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, name="data-prefetch", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._q is None:
            b = self.batch_at(self.step)
            self.step += 1
            return b
        step, b = self._q.get()
        self.step = step + 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    # -- checkpointable state ---------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed, "dp_rank": self.dp_rank}

    def load_state_dict(self, d: dict) -> None:
        if d.get("seed", self.cfg.seed) != self.cfg.seed:
            raise ValueError("restoring data state with a different seed")
        was_running = self._q is not None
        if was_running:
            self.stop()
        self.step = int(d["step"])
        if was_running:
            self.start()


def make_eval_batch(model: Model, shape: ShapeSpec, seed: int = 7) -> Dict[str, np.ndarray]:
    pipe = SyntheticPipeline(model, shape, DataConfig(seed=seed))
    return pipe.batch_at(0)
