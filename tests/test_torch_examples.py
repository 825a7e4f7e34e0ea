"""The port's examples (``examples_torch/``) on the CPU, against the JAX
package's host paths.

Each script is loaded by its path and its ``run("cpu")`` (the kernels'
plain PyTorch twins) is held byte for byte against the JAX package's host
oracles on the same seeded inputs: the v2 framing through its host
encoder, ``interleaved2.encode_iid_categorical2(..., device=False)``,
``encode_shared`` with ``build_checkpoints``, ``pallas_family``'s numpy
family tables and decoder, ``exact_family.exact_ecp`` /
``decode_family_exact_host``, the TChain-16 host decode and the
``AnsCoderCore`` words; every decode equals its input.  No case makes an
interpret-mode Pallas call (the JAX examples' own test pays for those), and
the JAX package's ``native.LIB`` is set to None, so its numpy branches are
the oracle.  One subprocess runs a script with ``--device cpu`` and finds
neither jax nor the JAX package in its ``sys.modules``; ``--device cuda``
raises without a card.  Integer coding: tolerance is equality.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from constriction_tpu import native as ref_native
from constriction_tpu import tpu as ref_tpu
from constriction_tpu.models.quantized import QuantizedFamily as RefFamily
from constriction_tpu.ops import exact_family as ref_ef
from constriction_tpu.ops import framing as ref_framing
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops import pallas_family as ref_pf
from constriction_tpu.ops import tchain as ref_tchain
from constriction_tpu.ops.ans import AnsCoderCore as RefAnsCoderCore
from constriction_tpu.ops.interleaved import LaneConfig as RefCfg
from constriction_tpu_torch.ops import interleaved2 as il2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")
SCRIPTS = ("bits_back", "compact_framing", "default_preset",
           "multichip_sharded", "neural_latents", "reference_exact_and_seek")


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host functions take their numpy branches."""
    monkeypatch.setattr(ref_native, "LIB", None)


@functools.lru_cache(maxsize=None)
def script(name: str):
    """The example ``examples_torch/<name>.py``, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"_examples_torch_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def ran(name: str) -> dict:
    """``run("cpu")`` of the example, once a process."""
    return script(name).run("cpu")


def ref_cfg(cfg) -> RefCfg:
    return RefCfg(cfg.num_lanes, cfg.word_bits, cfg.state_bits, cfg.precision)


def same(a, b) -> None:
    """Equal arrays: dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def planes(cdf, symbols):
    """(cum, prob) u64 of i.i.d. symbols under ``cdf``."""
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    return cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols]


def test_every_jax_example_has_a_port():
    assert sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                  if f.endswith(".py")) == list(SCRIPTS)
    for name in SCRIPTS:
        assert callable(script(name).run) and callable(script(name).main)


# ---------------------------------------------------------------------------
# default_preset.py: W=32, S=64, P=24
# ---------------------------------------------------------------------------


def test_default_preset_rans_container():
    mod, out = script("default_preset"), ran("default_preset")
    x = mod.inputs()
    same(out["container"], ref_framing.encode_iid_v2(
        x["symbols"], x["cdf"], ref_cfg(mod.CFG), device=False))
    same(out["decoded"], ref_framing.decode_iid_v2(out["container"],
                                                   x["cdf"]))
    assert np.array_equal(out["decoded"], x["symbols"])


def test_default_preset_range_pair():
    mod, out = script("default_preset"), ran("default_preset")
    x = mod.inputs()
    points, stream = il2.encode_shared_range_plain(
        *planes(x["cdf"], x["symbols"]), mod.CFG)
    same(out["points"], points)
    same(out["stream"], stream)
    got = ref_il2.decode_shared_range_cdf(out["points"], out["stream"], mod.N,
                                          x["cdf"], ref_cfg(mod.CFG))
    assert np.array_equal(got, x["symbols"])
    assert np.array_equal(out["range_decoded"], x["symbols"])


def test_default_preset_exact_family():
    mod, out = script("default_preset"), ran("default_preset")
    x = mod.inputs()
    cfg = ref_cfg(mod.CFG)
    args = (x["means"], x["scales"], "gaussian", -100, 100)
    cums, probs = ref_ef.exact_ecp(x["family_symbols"], *args, 24)
    states, stream = ref_il2.encode_shared(cums, probs, cfg)
    same(out["family_states"], states)
    same(out["family_stream"], stream)
    got = ref_ef.decode_family_exact_host(states, stream, *args, cfg, mod.N)
    assert np.array_equal(got, x["family_symbols"])
    assert np.array_equal(out["family_decoded"], x["family_symbols"])


# ---------------------------------------------------------------------------
# compact_framing.py: P=24, 2^20 symbols
# ---------------------------------------------------------------------------


def _facade_cfg(symbols, cdf):
    """The JAX facade's lane config and code lengths for ``encode_iid``."""
    cdf64 = np.asarray(cdf, dtype=np.float64)
    sym_bits = -np.log2((cdf64[symbols + 1] - cdf64[symbols]) / cdf64[-1])
    cfg = ref_tpu._pick_cfg(len(symbols), None, cdf,
                            est_bits=float(sym_bits.sum()))
    return cfg, sym_bits


def test_compact_framing_containers():
    mod, out = script("compact_framing"), ran("compact_framing")
    x = mod.inputs()
    cfg, sym_bits = _facade_cfg(x["symbols"], x["cdf"])
    same(out["v2"], ref_framing.encode_iid_v2(
        x["symbols"], x["cdf"], cfg, device=False, sym_bits=sym_bits))
    same(out["v1"], ref_il2.encode_iid_categorical2(
        x["symbols"], x["cdf"], cfg, device=False))
    assert np.array_equal(out["decoded"], x["symbols"])


def test_compact_framing_reference_words():
    mod, out = script("compact_framing"), ran("compact_framing")
    x = mod.inputs()
    ref = RefAnsCoderCore(word_bits=32, state_bits=64)
    cums, probs = planes(x["cdf"], x["symbols"])
    ref.encode_reverse_tables(cums.astype(np.uint32),
                              probs.astype(np.uint32), mod.P)
    same(out["reference_words"], ref.get_compressed())


def test_compact_framing_checkpoint_seek():
    mod, out = script("compact_framing"), ran("compact_framing")
    x = mod.inputs()
    offsets, states = ref_framing.build_checkpoints_v2(out["v2"], x["cdf"],
                                                       mod.INTERVAL)
    same(out["offsets"], offsets)
    same(out["states"], states)
    assert out["seek_start"] == (len(offsets) // 2 + 1) * mod.INTERVAL * (
        ref_framing.peek_cfg(out["v2"]).num_lanes)
    assert np.array_equal(out["suffix"], x["symbols"][out["seek_start"]:])


# ---------------------------------------------------------------------------
# bits_back.py: TChain-16 on the host, the payload at W=16, S=32, P=12
# ---------------------------------------------------------------------------


def test_bits_back_latent_and_remainders():
    mod, out = script("bits_back"), ran("bits_back")
    x = mod.inputs()
    z, rem, heads = ref_tchain.tchain_decode_host(
        x["side_info"], x["posterior"].cdf, ref_cfg(mod.CFG16))
    assert out["z"] == int(z[0])
    same(out["remainders"], rem)
    same(out["heads"], heads)
    same(out["recovered_side_info"], x["side_info"])


def test_bits_back_container():
    mod, out = script("bits_back"), ran("bits_back")
    x = mod.inputs()
    cdf = x["models12"][out["z"]].cdf
    same(out["container"], ref_il2.encode_iid_categorical2(
        x["message"], cdf, ref_cfg(mod.CFG12), device=False))
    assert np.array_equal(out["decoded"], x["message"])


# ---------------------------------------------------------------------------
# multichip_sharded.py: eight "cpu" blocks of 4000 symbols
# ---------------------------------------------------------------------------


def test_multichip_blocks():
    mod, out = script("multichip_sharded"), ran("multichip_sharded")
    assert out["devices"] == ["cpu"] * 8
    x = mod.inputs(8)
    blocks = x["message"].reshape(8, mod.BLOCK_LEN)
    for b, blk in enumerate(blocks):
        states, stream = ref_il2.encode_shared(*planes(x["cdf"], blk),
                                               ref_cfg(mod.CFG))
        same(out["states"][b], states)
        same(out["streams"][b], stream)
    same(out["container"], np.concatenate(out["streams"]))
    assert np.array_equal(out["decoded"], x["message"])


def test_multichip_rate_line():
    """The JAX example's bits per symbol: the same format, the same
    count."""
    mod, out = script("multichip_sharded"), ran("multichip_sharded")
    x = mod.inputs(8)
    words = sum(len(ref_il2.encode_shared(*planes(x["cdf"], blk),
                                          ref_cfg(mod.CFG))[1])
                for blk in x["message"].reshape(8, mod.BLOCK_LEN))
    bits = words * 16 + 8 * mod.CFG.num_lanes * 32
    assert out["bits_per_symbol"] == bits / len(x["message"])
    assert f"{bits / len(x['message']):.3f} bits/sym" in out["lines"][1]


# ---------------------------------------------------------------------------
# neural_latents.py: 512 x 512 synthetic latents, L=1024
# ---------------------------------------------------------------------------


def test_neural_latents_host_container():
    mod, out = script("neural_latents"), ran("neural_latents")
    x = mod.inputs()
    cfg = ref_cfg(mod.CFG)
    fam = RefFamily("gaussian", *mod.SUPPORT, x["means"], x["stds"],
                    precision=12)
    states, stream = ref_il2.encode_shared(*fam.ecp_all(x["symbols"]), cfg)
    same(out["container"], ref_il2.pack_container2(states, stream,
                                                   len(x["symbols"]), cfg))


def test_neural_latents_host_decode():
    """The host codec's per-element decode, its plain version (the exact
    family's host decode) and the JAX package's."""
    mod, out = script("neural_latents"), ran("neural_latents")
    x = mod.inputs()
    assert np.array_equal(out["host_decoded"], x["symbols"])
    from constriction_tpu_torch.ops import exact_family as ef

    states, stream, n, cfg = il2.unpack_container2(out["container"])
    args = (x["means"], x["stds"], "gaussian", *mod.SUPPORT)
    got = ef.decode_family_exact_host(states, stream, *args, cfg, n)
    same(got, ref_ef.decode_family_exact_host(states, stream, *args,
                                              ref_cfg(cfg), n))
    assert np.array_equal(got, x["symbols"])


def test_neural_latents_device_family():
    mod, out = script("neural_latents"), ran("neural_latents")
    x = mod.inputs()
    cfg = ref_cfg(mod.CFG)
    args = (x["means"].astype(np.float32), x["stds"].astype(np.float32),
            "gaussian", *mod.SUPPORT)
    states, stream = ref_il2.encode_shared(
        *ref_pf.family_tables_host(x["symbols"], *args), cfg)
    same(out["family_states"], states)
    same(out["family_stream"], stream)
    got = ref_pf.decode_family_host(states, stream, *args, cfg,
                                    len(x["symbols"]))
    assert np.array_equal(got, x["symbols"])
    same(out["family_decoded"], x["symbols"])


# ---------------------------------------------------------------------------
# reference_exact_and_seek.py: the CPU size (20000 symbols, 256 lanes)
# ---------------------------------------------------------------------------


def test_reference_exact_family():
    mod, out = script("reference_exact_and_seek"), ran(
        "reference_exact_and_seek")
    x = mod.inputs("cpu")
    cfg = ref_cfg(x["cfg"])
    args = (x["means"], x["stds"], "gaussian", -100, 100)
    states, stream = ref_il2.encode_shared(
        *ref_ef.exact_ecp(x["symbols"], *args, 12), cfg)
    same(out["states"], states)
    same(out["stream"], stream)
    got = ref_ef.decode_family_exact_host(states, stream, *args, cfg,
                                          len(x["symbols"]), cmax=128)
    assert np.array_equal(got, x["symbols"])
    assert np.array_equal(out["decoded"], x["symbols"])


def test_reference_exact_seek():
    mod, out = script("reference_exact_and_seek"), ran(
        "reference_exact_and_seek")
    x = mod.inputs("cpu")
    cfg = ref_cfg(x["cfg"])
    n = len(x["msg"])
    states, stream = ref_il2.encode_shared(*planes(x["cdf"], x["msg"]), cfg)
    same(out["iid_states"], states)
    same(out["iid_stream"], stream)
    offsets, ckpt = ref_il2.build_checkpoints(states, stream, n, x["cdf"],
                                              cfg, mod.INTERVAL)
    same(out["offsets"], offsets)
    same(out["checkpoint_states"], ckpt)
    start, suffix = ref_il2.decode_from_checkpoint(
        len(offsets) // 2, offsets, ckpt, stream, n, x["cdf"], cfg,
        mod.INTERVAL, device=False)
    assert out["seek_start"] == start
    assert np.array_equal(out["suffix"], suffix)
    assert np.array_equal(suffix, x["msg"][start:])


# ---------------------------------------------------------------------------
# the scripts as a user runs them
# ---------------------------------------------------------------------------


def test_scripts_import_no_jax():
    """Every script loaded, one run with ``--device cpu``: neither jax nor
    the JAX package is imported."""
    code = (
        "import importlib.util, os, sys\n"
        f"d = {EXAMPLES!r}\n"
        "mods = {}\n"
        f"for name in {SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, os.path.join(d, name + '.py'))\n"
        "    mods[name] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mods[name])\n"
        "assert mods['default_preset'].main(['--device', 'cpu']) == 0\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'constriction_tpu')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "[]", lines[-1]
    assert lines[:-1] == ran("default_preset")["lines"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_device_cuda_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script(name).main(["--device", "cuda"])
