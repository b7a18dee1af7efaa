"""emspec_torch.tables: the numpy copies of table functions that live in
jax-importing emspec modules must stay bit-equal to their originals, and
the port must import no jax."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from emspec.config import COLORMAPS
from emspec.dsp import multires
from emspec.pipeline import _row_map_consts
from emspec.post import chain, colormap
from emspec_torch import tables


@pytest.mark.parametrize("name", COLORMAPS)
def test_lut_bit_equal(name):
    np.testing.assert_array_equal(tables.lut(name), colormap.lut(name))
    assert tables.lut(name).dtype == np.uint8


@pytest.mark.parametrize("rows,f_min,zoom", [(512, 20.0, 1.0), (128, 30.0, 2.5),
                                             (7, 20.0, 0.02)])
def test_log_freq_axis_bit_equal(rows, f_min, zoom):
    np.testing.assert_array_equal(
        tables.log_freq_axis(rows, f_min, 24000.0, zoom),
        multires.log_freq_axis(rows, f_min, 24000.0, zoom))


@pytest.mark.parametrize("n_banks", [1, 2, 3])
def test_band_weight_at_bit_equal(n_banks):
    f = np.linspace(1.0, 24000.0, 301)
    for bank in range(n_banks):
        np.testing.assert_array_equal(
            tables.band_weight_at(f, bank, n_banks, 200.0, 2000.0),
            multires.band_weight_at(f, bank, n_banks, 200.0, 2000.0))


def test_bank_offsets_and_row_map_bit_equal():
    for sizes in [(8192,), (8192, 2048, 512), (1024, 512)]:
        assert tables.bank_offsets(sizes) == multires.bank_offsets(sizes)
    f = multires.log_freq_axis(512, 20.0, 24000.0, 1.3)
    tables_ab = tables.row_map_consts(f, 512)
    jax_ab = _row_map_consts(multires.MergeTables(f, (), (), ()), 512)
    assert tables_ab == jax_ab
    assert all(v.dtype == np.float32 for v in tables_ab)


@pytest.mark.parametrize("boost,cutoff", [(3.9, 200.0), (1.0, 50.0), (7.5, 1000.0)])
def test_low_end_ramp_bit_equal(boost, cutoff):
    f = multires.log_freq_axis(512, 20.0, 24000.0)
    np.testing.assert_array_equal(tables.low_end_ramp(f, boost, cutoff),
                                  chain.low_end_ramp(f, boost, cutoff))


def test_port_imports_no_jax():
    """The card machine has no JAX: the port's entry modules (and the
    kernel build, converter, validator and the on-card smoke script) must
    not pull it in."""
    code = ("import sys, emspec_torch, emspec_torch.pipeline, "
            "emspec_torch.stream, emspec_torch.convert, "
            "emspec_torch.validate, emspec_torch.kernels_build, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib')]; "
            "assert not bad, bad; print('ok')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: its own imports name the
    port, torch, numpy and the standard library, never the JAX package."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    nodes = list(ast.walk(ast.parse(src)))
    names = {a.name for n in nodes if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in nodes if isinstance(n, ast.ImportFrom)}
    top = {m.split(".")[0] for m in names}
    assert "emspec_torch" in top and "torch" in top
    assert not top & {"emspec", "jax", "jaxlib"}, top
