"""Model facade over the families: SSM, hybrid, dense, MoE, audio
(encoder–decoder) and VLM (the dense model with a patch-embedding prefix).

    m = Model(cfg, mesh)
    m.param_specs()            spec tree (shapes/axes/init in one declaration)
    m.axes()                   the logical-axes tree (``sharding.Partitioner``)
    m.init(generator)          tensors on the generator's device
    m.shapes()                 the parameters as meta tensors
    m.loss(params, batch)      (loss, metrics), differentiable by autograd
    m.prefill / m.decode_step  serving steps
    m.batch_specs(shape)       input Spec tree for a ShapeSpec
    m.cache_specs(shape)       serving-state Spec tree for decode shapes

Training covers the dense, VLM, MoE and audio families, whose JAX
``forward_train`` runs no Pallas kernel.  On a ``mesh``
(``launch.mesh.Mesh``) the parameters may be ``sharding.Placed`` blocks.
The dense, VLM and MoE families compute this rank's heads, KV heads, FFN
columns and vocabulary where those leaves are split over "model"
(``keep_local``: at use they stay the rank's blocks, and ``loss`` takes a
vocabulary-parallel cross-entropy), and the MoE family routes tokens to
expert shards over "model" (``moe.moe_ffn``'s expert-parallel paths; the
experts reach it as blocks).  The audio, SSM and hybrid families gather
every leaf whole at use and compute as on one device (ROADMAP item 5b).
Batch inputs are this rank's rows.  ``logits`` refuses the SSM and
hybrid families, whose kernels have no backward, naming the ROADMAP entry
for each.  The MoE family's loss adds ``aux_loss_weight`` times its
load-balance term, as the JAX package's does.
"""

from __future__ import annotations

import torch

from . import encdec, hybrid, moe, ssm, transformer
from .config import ModelConfig, ShapeSpec
from .layers import xent_loss
from repro_torch.sharding.placement import BLOCK_AXES, TENSOR_PARALLEL, at_use

from .param import Spec
from .param import axes as spec_axes
from .param import init as spec_init
from .param import shapes as spec_shapes

#: the families whose training is not ported, and the ROADMAP entry for each
_NOT_TRAINED = {
    "ssm": "ROADMAP section 4, open question: the SSD kernel has no backward, in JAX as here",
    "hybrid": "ROADMAP section 4, open question: the RG-LRU kernel has no backward, in JAX as here",
}

#: the families whose layers compute this rank's share of a split leaf
_TENSOR_PARALLEL = ("dense", "vlm", "moe")

_FAMILY = {
    "ssm": ssm,
    "hybrid": hybrid,
    "dense": transformer,
    "moe": moe,
    "audio": encdec,
    "vlm": transformer,
}


class Model:
    def __init__(self, cfg: ModelConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.mod = _FAMILY[cfg.family]
        tensor_parallel = cfg.family in _TENSOR_PARALLEL
        #: the mesh, for the families whose functions take it
        self._mesh_kw = {"mesh": mesh} if tensor_parallel else {}
        #: the logical axes whose split a block keeps at use (``sharding.place``):
        #: its heads, KV heads, FFN columns and vocabulary where the model's
        #: own mesh splits them ("model" > 1; a model without one gathers them
        #: whole), and the MoE experts, which ``moe_ffn`` reshards to its
        #: path's spec
        split = tensor_parallel and mesh is not None and mesh.shape.get("model", 1) > 1
        self.keep_local = (TENSOR_PARALLEL if split else ()) + (BLOCK_AXES if cfg.family == "moe" else ())

    def on_mesh(self, mesh) -> "Model":
        """This model for blocks placed on ``mesh``: itself where it is on
        ``mesh`` (or has no mesh and ``mesh`` has one rank), else the same
        configuration on ``mesh``, whose layers compute and sum the blocks
        they hold there."""
        if self.mesh is mesh or (self.mesh is None and mesh.size == 1):
            return self
        return Model(self.cfg, mesh)

    # -- parameters ------------------------------------------------------------
    def param_specs(self) -> dict:
        return self.mod.specs(self.cfg)

    def init(self, generator: torch.Generator) -> dict:
        """Weights on ``generator.device``, drawn from ``generator``."""
        return spec_init(self.param_specs(), generator, self.cfg.dtype)

    def shapes(self) -> dict:
        return spec_shapes(self.param_specs(), self.cfg.dtype)

    def axes(self) -> dict:
        return spec_axes(self.param_specs())

    # -- training ---------------------------------------------------------------
    def check_trainable(self) -> None:
        """Raises ``NotImplementedError`` for a family whose training is not
        ported."""
        where = _NOT_TRAINED.get(self.cfg.family)
        if where is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: training the {self.cfg.family} family is not ported ({where})"
            )

    def logits(self, params: dict, batch: dict):
        """(logits, auxiliary loss) over the whole sequence (the logits over
        this rank's vocabulary columns where the vocabulary is split): the
        MoE family's load-balance term, an fp32 zero for the others."""
        self.check_trainable()
        params = at_use(params, top=True)
        if self.cfg.family == "moe":
            return self.mod.forward_train(self.cfg, params, batch, **self._mesh_kw)
        out = self.mod.forward_train(self.cfg, params, batch, **self._mesh_kw)
        return out, torch.zeros((), dtype=torch.float32, device=out.device)

    def loss(self, params: dict, batch: dict):
        """(loss, {"ce", "aux"}): the mean cross-entropy, plus
        ``aux_loss_weight`` times the load-balance term for the MoE family; a
        VLM's loss covers only the text positions."""
        logits, aux = self.logits(params, batch)
        if self.cfg.vision_tokens:
            logits = logits[:, self.cfg.vision_tokens :]
        ce = xent_loss(self.cfg, logits, batch["labels"], self._mesh_kw.get("mesh"))
        total = ce
        if self.cfg.family == "moe":
            total = ce + self.cfg.moe.aux_loss_weight * aux
        return total, {"ce": ce, "aux": aux}

    # -- serving -----------------------------------------------------------------
    def prefill(self, params: dict, batch: dict, cache_len: int):
        return self.mod.prefill(self.cfg, at_use(params, top=True), batch, cache_len, **self._mesh_kw)

    def decode_step(self, params: dict, cache: dict, batch: dict):
        return self.mod.decode_step(self.cfg, at_use(params, top=True), cache, batch, **self._mesh_kw)

    # -- input/cache declarations --------------------------------------------------
    def batch_specs(self, shape: ShapeSpec) -> dict:
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            out = {
                "tokens": Spec((B, self._text_len(S)), ("batch", "seq"), dtype="int32"),
                "labels": Spec((B, self._text_len(S)), ("batch", "seq"), dtype="int32"),
            }
            self._add_frontend(out, B)
            return out
        if shape.kind == "prefill":
            out = {"tokens": Spec((B, self._text_len(S)), ("batch", "seq"), dtype="int32")}
            self._add_frontend(out, B)
            return out
        return {"token": Spec((B,), ("batch",), dtype="int32")}

    def _text_len(self, S: int) -> int:
        return S - self.cfg.vision_tokens if self.cfg.vision_tokens else S

    def _add_frontend(self, out: dict, B: int) -> None:
        cfg = self.cfg
        if cfg.family == "audio":
            out["frames"] = Spec((B, cfg.encdec.enc_positions, cfg.d_model), ("batch", None, "embed"))
        if cfg.vision_tokens:
            out["patch_embeds"] = Spec((B, cfg.vision_tokens, cfg.d_model), ("batch", None, "embed"))

    def cache_specs(self, shape: ShapeSpec) -> dict:
        return self.mod.cache_specs(self.cfg, shape.global_batch, shape.seq_len)

    # -- analytics ----------------------------------------------------------------
    def model_flops_per_token(self) -> int:
        """6·N_active, the JAX package's MODEL_FLOPS convention."""
        return 6 * self.cfg.active_params()
