"""Scaling-efficiency harness on the virtual CPU mesh (schedule check)."""

from pem_spgemm.models.synthetic import banded, power_law
from pem_spgemm.parallel.distributed import (initialize, pod_mesh,
                                             scaling_efficiency)


def test_initialize_single_process_noop():
    assert initialize() == 1


def test_pod_mesh_shapes():
    m = pod_mesh(4)
    assert m.devices.shape == (4,)


def test_scaling_points_tile16():
    coo = banded(1500, bands=(0, 1, -1, 40, -40))
    pts = scaling_efficiency(coo, engine="tile16", max_devices=4,
                             repeats=1, verbose=False)
    ns = [p.n_devices for p in pts]
    assert ns[0] == 1 and ns[-1] == 4
    assert all(p.c_nnz == pts[0].c_nnz for p in pts)
    assert all(p.efficiency > 0 for p in pts)


def test_scaling_points_element():
    coo = power_law(n=2500, nnz=8000, seed=4, hub_correlation=0.1)
    pts = scaling_efficiency(coo, engine="element", max_devices=4,
                             repeats=1, verbose=False)
    assert all(p.c_nnz == pts[0].c_nnz for p in pts)
