"""The three-stage curriculum: speech, then skeletal, then late fusion over
the two encoders they trained, grafted in and frozen
(``mgr_tpu/train/curriculum.py``).

Parameters are state dicts keyed by the JAX pytree paths joined with dots
(``speech.blstm_0.W``). The fusion stage loads the graft into the model
and trains it with ``fit`` from those weights, without ``resume``: the
port's ``fit`` starts from the model's weights, so no ``latest`` slot is
seeded for it to resume from (a resume would also restore the plateau
controller's state of whatever ran before in the workdir). The donors'
slots may be the port's ``.pt`` or the JAX package's msgpack
(``core.checkpoint.read_params``), so encoders trained by JAX graft bit
for bit. Each stage's ``fit`` takes its default data path: the corpus on
the device, batches gathered there, or over a mesh host batches through
the mesh steps. On a mesh (``mgr_tpu/train/curriculum.py:66-112``) every
stage trains over it; rank 0 writes the slots, ``fit``'s closing barrier
has them on disk before any rank reads the donors, and each rank builds
the late-fusion model on its own device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mgr_tpu_torch.core import checkpoint as ckpt_lib
from mgr_tpu_torch.core.config import PipelineConfig, get_preset
from mgr_tpu_torch.data.batcher import Batcher
from mgr_tpu_torch.models import zoo
from mgr_tpu_torch.train.loop import FitResult, fit

Params = Dict[str, torch.Tensor]

ENCODERS = ("speech", "skeletal")


def graft_pretrained_encoders(fusion_params: Params, speech_params: Params,
                              skeletal_params: Params) -> Params:
    """A late-fusion state dict with ``speech.*`` and ``skeletal.*``
    replaced by the ``encoder.*`` of each uni-modal state dict. Every
    encoder parameter of the fusion model must be replaced, and by one of
    the same shape."""
    out = dict(fusion_params)
    for name, donor in zip(ENCODERS, (speech_params, skeletal_params)):
        graft = {f"{name}.{k[len('encoder.'):]}": v for k, v in donor.items()
                 if k.startswith("encoder.")}
        want = {k for k in fusion_params if k.startswith(f"{name}.")}
        if set(graft) != want:
            raise ValueError(f"{name} encoder: the donor has {sorted(graft)}, the fusion "
                             f"model {sorted(want)}")
        for k, v in graft.items():
            if tuple(v.shape) != tuple(fusion_params[k].shape):
                raise ValueError(f"{k}: donor shape {tuple(v.shape)}, fusion "
                                 f"{tuple(fusion_params[k].shape)}")
        out.update(graft)
    return out


def build_fusion_with_pretrained(
    workdir: str,
    fusion_cfg: Optional[PipelineConfig] = None,
    source_configs: Optional[Dict[str, PipelineConfig]] = None,
    *,
    slot: str = "best",
    device: torch.device | str = "cuda",
) -> zoo.LateFusionModel:
    """The late-fusion model of ``fusion_cfg`` (default: the preset), on
    ``device``, with the ``slot`` parameters of the speech and skeletal
    pipelines in ``workdir`` (``.pt`` or JAX msgpack slots) grafted into
    its encoders."""
    fusion_cfg = fusion_cfg or get_preset("late_fusion")
    sources = source_configs or {name: get_preset(name) for name in ENCODERS}
    model = zoo.build_model(fusion_cfg, sources, device=device)
    grafted = graft_pretrained_encoders(
        model.state_dict(), *(ckpt_lib.read_params(workdir, name, slot=slot)
                              for name in ENCODERS))
    model.load_state_dict(grafted, strict=True)
    return model


def run_curriculum(
    speech_data: Batcher,
    skeletal_data: Batcher,
    fusion_data: Batcher,
    workdir: str,
    *,
    configs: Optional[Dict[str, PipelineConfig]] = None,
    mesh=None,
    epochs: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> Dict[str, FitResult]:
    """Trains speech and skeletal into ``workdir``, then late fusion from
    their best slots. ``configs`` maps "speech", "skeletal" and
    "late_fusion" to their configs (default: the presets); ``mesh``
    (``parallel.mesh.Mesh``) trains every stage over a mesh of ranks, on
    ``mesh.device`` in place of ``device``; ``epochs`` overrides every
    stage's epoch budget."""
    cfgs = configs or {name: get_preset(name) for name in ENCODERS + ("late_fusion",)}
    dev = device if mesh is None else mesh.device
    results: Dict[str, FitResult] = {}
    for stage, data in zip(ENCODERS, (speech_data, skeletal_data)):
        model = zoo.build_model(cfgs[stage], device=dev)
        results[stage] = fit(model, data, workdir=workdir, mesh=mesh, epochs=epochs)
    fusion = build_fusion_with_pretrained(
        workdir, cfgs["late_fusion"], {name: cfgs[name] for name in ENCODERS}, device=dev)
    results["late_fusion"] = fit(fusion, fusion_data, workdir=workdir, mesh=mesh,
                                 epochs=epochs)
    return results
