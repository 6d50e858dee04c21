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
(``launch.mesh.Mesh``) the MoE family routes tokens to expert shards over
its "model" axis (``moe.moe_ffn``'s expert-parallel paths) and the others
run as on one device; the parameters may then be ``sharding.Placed``
blocks, each gathered whole where a block uses it (the MoE experts stay
blocks).  Batch inputs are this rank's rows.  ``logits`` refuses the SSM and
hybrid families, whose kernels have no backward, naming the ROADMAP entry
for each.  The MoE family's loss adds ``aux_loss_weight`` times its
load-balance term, as the JAX package's does.
"""

from __future__ import annotations

import torch

from . import encdec, hybrid, moe, ssm, transformer
from .config import ModelConfig, ShapeSpec
from .layers import xent_loss
from repro_torch.sharding.placement import at_use

from .param import Spec
from .param import axes as spec_axes
from .param import init as spec_init
from .param import shapes as spec_shapes

#: the families whose training is not ported, and the ROADMAP entry for each
_NOT_TRAINED = {
    "ssm": "ROADMAP section 4, open question: the SSD kernel has no backward, in JAX as here",
    "hybrid": "ROADMAP section 4, open question: the RG-LRU kernel has no backward, in JAX as here",
}

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
        #: the mesh, for the one family whose functions take it
        self._mesh_kw = {"mesh": mesh} if cfg.family == "moe" else {}
        #: the leaves a block takes as this rank's block, not gathered whole
        #: (the MoE experts, which ``moe_ffn`` reshards to its path's spec)
        self.keep_local = self.mod.EXPERT_LEAVES if cfg.family == "moe" else ()

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
        """(logits, auxiliary loss) over the whole sequence: the MoE family's
        load-balance term, an fp32 zero for the others."""
        self.check_trainable()
        params = at_use(params, top=True)
        if self.cfg.family == "moe":
            return self.mod.forward_train(self.cfg, params, batch, **self._mesh_kw)
        out = self.mod.forward_train(self.cfg, params, batch)
        return out, torch.zeros((), dtype=torch.float32, device=out.device)

    def loss(self, params: dict, batch: dict):
        """(loss, {"ce", "aux"}): the mean cross-entropy, plus
        ``aux_loss_weight`` times the load-balance term for the MoE family; a
        VLM's loss covers only the text positions."""
        logits, aux = self.logits(params, batch)
        if self.cfg.vision_tokens:
            logits = logits[:, self.cfg.vision_tokens :]
        ce = xent_loss(self.cfg, logits, batch["labels"])
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
