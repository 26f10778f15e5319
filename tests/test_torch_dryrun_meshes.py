"""Every architecture's smoke config, each of its shapes, through the port's
dry run (``repro_torch.launch.dryrun.trace_cell``) on the (16, 16) and
(2, 16, 16) production meshes of a fake process group: the shapes keep
their kind and batch (so the batch sharding, or a long context's sequence
sharding, is the production one) at a short sequence. The full-width cells
are ``python -m repro_torch.launch.dryrun --all --mesh both``.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ARCH_IDS, SHAPES_BY_NAME, get_config, get_smoke_config, shapes_for
from repro_torch.models.config import ShapeConfig


def _small(shape: ShapeConfig) -> ShapeConfig:
    return ShapeConfig(shape.name, min(shape.seq_len, 512 if shape.global_batch == 1 else 128),
                       shape.global_batch, shape.kind)


@pytest.fixture(params=["pod", "multipod"])
def production_mesh(request):
    multi = request.param == "multipod"
    dryrun.fake_group(512 if multi else 256)
    yield make_production_mesh(multi_pod=multi, device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_cells_run_on_the_production_meshes(production_mesh, arch):
    cfg = dryrun._arch_for_mesh(get_smoke_config(arch), production_mesh)
    for shape in shapes_for(get_config(arch)):
        rec = dryrun.trace_cell(cfg, _small(SHAPES_BY_NAME[shape.name]), production_mesh,
                                torch.device("cpu"))
        hlo = rec["hlo"]
        assert hlo["flops_per_device"] > 0 and hlo["bytes_per_device"] > 0, shape.name
        assert hlo["unknown_trip_loops"] == 0
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
