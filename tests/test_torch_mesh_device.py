"""``parallel/mesh.py`` with ``device_type=None`` takes the mesh's device
from the default process group's backend (nccl -> "cuda", gloo -> "cpu"),
never from whether a card is present; any other backend raises naming the
argument. A world-1 gloo group in this process; ~1 s."""

import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import mesh as tmesh


@pytest.fixture
def gloo_world():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("card", [False, True], ids=["no-card", "card-present"])
def test_gloo_world_gives_a_cpu_mesh(gloo_world, monkeypatch, card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    assert tmesh.create_mesh(tmesh.MeshConfig()).device_type == "cpu"
    assert tmesh.single_axis_mesh("dp").device_type == "cpu"


def test_unknown_backend_raises(gloo_world, monkeypatch):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "mpi")
    with pytest.raises(ValueError, match="device_type"):
        tmesh.create_mesh(tmesh.MeshConfig())
    # An explicit device_type needs no backend rule.
    monkeypatch.undo()
    assert tmesh.create_mesh(tmesh.MeshConfig(), device_type="cpu").device_type == "cpu"
