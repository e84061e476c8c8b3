"""The port's crossbar substrate against the reference: encoding (exact
at sigma_program = 0 and with the programming draw injected, the write
ledger exact with noise on), the ECC median, faults, the array's MVM on
the reference's conductances, and B6's plain version against the Pallas
kernel in interpret mode.  f64 unless a test says otherwise, on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import assert_ledgers_equal, noiseless_device

from repro_torch import kernels
from repro_torch.crossbar import (
    EPIRAM,
    TAOX_HFOX,
    CrossbarArray,
    Ledger,
    analog_linear,
    ecc_decode,
    encode_core,
    encode_matrix,
    write_verify_error,
)
from repro_torch.interop import device_from_reference, from_reference_encoded
from repro_torch.kernels.crossbar_mvm import crossbar_mvm, crossbar_mvm_plain

# logical shapes, tile-padded to 64-multiples by encode_matrix
RAGGED = [(30, 40), (70, 100), (64, 64)]


def _ref_crossbar():
    pytest.importorskip("jax")
    import repro.crossbar as rx

    return rx


def _W(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def _ref_encode(W, dev, seed=0):
    import jax

    rx = _ref_crossbar()
    led = rx.Ledger()
    enc = rx.encode_matrix(W, dev, jax.random.PRNGKey(seed), ledger=led)
    return enc, led


@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dev_name", ["EPIRAM", "TAOX_HFOX"])
def test_encode_matches_reference_without_programming_noise(x64, shape,
                                                           dev_name):
    rx = _ref_crossbar()
    ref_dev = noiseless_device(getattr(rx, dev_name))
    W = _W(sum(shape), shape)
    ref, ref_led = _ref_encode(W, ref_dev)
    led = Ledger()
    enc = encode_matrix(torch.from_numpy(W), device_from_reference(ref_dev),
                        ledger=led)
    np.testing.assert_allclose(enc.g_pos.numpy(), np.asarray(ref.g_pos),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(enc.g_neg.numpy(), np.asarray(ref.g_neg),
                               rtol=1e-12, atol=0)
    assert enc.scale == ref.scale and enc.fill == ref.fill
    assert (enc.rows, enc.cols) == (ref.rows, ref.cols) == shape
    assert enc.active_cells == ref.active_cells
    np.testing.assert_allclose(enc.decode().numpy(), np.asarray(ref.decode()),
                               rtol=1e-12, atol=1e-15)
    assert_ledgers_equal(led, ref_led)


@pytest.mark.parametrize("dev_name", ["EPIRAM", "TAOX_HFOX"])
def test_write_ledger_is_exact_with_programming_noise(x64, dev_name):
    """The write charge counts nonzero QUANTIZED targets, so it is the
    reference's to the last bit whatever the draws; the programmed error
    itself has relative std ``sigma_program``."""
    rx = _ref_crossbar()
    ref_dev = getattr(rx, dev_name)
    W = _W(11, (150, 130))
    _, ref_led = _ref_encode(W, ref_dev)
    dev = device_from_reference(ref_dev)
    led = Ledger()
    gen = torch.Generator().manual_seed(5)
    enc = encode_matrix(torch.from_numpy(W), dev, gen, ledger=led)
    assert_ledgers_equal(led, ref_led)
    target = encode_matrix(torch.from_numpy(W), noiseless_device(dev))
    for g, q in ((enc.g_pos, target.g_pos), (enc.g_neg, target.g_neg)):
        on = q > 0
        rel = (g[on] / q[on] - 1.0).numpy()
        # tens of thousands of cells: the sample std is within 3 %
        assert abs(rel.std() / dev.sigma_program - 1.0) < 0.03
        assert abs(rel.mean()) < 5 * dev.sigma_program / np.sqrt(rel.size)
        assert float(g[~on].abs().max()) == 0.0
    assert write_verify_error(enc, torch.from_numpy(W)) < (
        1.5 / dev.g_levels + 6 * dev.sigma_program)


def test_encode_core_with_the_reference_draw_injected(x64):
    import jax

    rx = _ref_crossbar()
    W = _W(3, (64, 128))
    key = jax.random.PRNGKey(9)
    gp, gn, scale, nz = rx.encode_core(W, key, EPIRAM.g_levels,
                                       EPIRAM.sigma_program)
    # the fault-free path draws normal(k1), normal(k2) with k1, k2 =
    # split(key)
    k1, k2 = jax.random.split(key)
    draw = tuple(np.array(jax.random.normal(k, W.shape, W.dtype))
                 for k in (k1, k2))
    tp, tn, tscale, tnz = encode_core(torch.from_numpy(W), None,
                                      EPIRAM.g_levels, EPIRAM.sigma_program,
                                      program_draw=draw)
    np.testing.assert_allclose(tp.numpy(), np.asarray(gp), rtol=1e-15,
                               atol=0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(gn), rtol=1e-15,
                               atol=0)
    assert float(tscale) == float(scale) and int(tnz) == int(nz)
    with pytest.raises(ValueError, match="fault-free"):
        encode_core(torch.from_numpy(W), None, 256, 1e-3, ecc=3,
                    program_draw=draw)


def test_encode_counts_post_quantization_targets():
    """Sub-LSB entries quantize to zero conductance: not charged as
    nonzero-target pairs (the reference's regression, ported)."""
    W = torch.zeros((16, 16), dtype=torch.float64)
    W[0, 0] = 1.0
    W[1:5, 1:5] = 1e-6
    g_pos, g_neg, scale, nz = encode_core(
        W, torch.Generator().manual_seed(0), EPIRAM.g_levels,
        EPIRAM.sigma_program)
    assert int(nz) == 1
    assert torch.all(((g_pos - g_neg) * scale)[1:5, 1:5] == 0.0)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_ecc_median_matches_numpy_on_replica_stacks(k):
    stack = np.random.default_rng(k).normal(size=(k, 9, 13))
    got = ecc_decode(torch.from_numpy(stack), "median").numpy()
    np.testing.assert_array_equal(got, np.median(stack, axis=0))
    np.testing.assert_array_equal(
        ecc_decode(torch.from_numpy(stack), "mean").numpy(),
        np.mean(stack, axis=0))


def test_stuck_cells_follow_their_rate():
    """With a uniform target of 64/255, a cell reads 0 or 1 exactly when
    it is stuck: the stuck share and the ON share match their rates."""
    rate, n = 0.05, 256
    W = torch.full((n, n), 0.25, dtype=torch.float64)
    W[0, 0] = 1.0                                  # sets the scale
    g_pos, _, _, _ = encode_core(W, torch.Generator().manual_seed(1), 256,
                                 0.0, stuck_rate=rate)
    body = g_pos.flatten()[1:]
    stuck = (body == 0.0) | (body == 1.0)
    cells = body.numel()
    sd = np.sqrt(cells * rate * (1 - rate))
    assert abs(int(stuck.sum()) - rate * cells) < 5 * sd
    on = int((body == 1.0).sum())
    assert abs(on / int(stuck.sum()) - 0.5) < 0.05


def test_ecc_median_recovers_from_stuck_cells():
    W = torch.from_numpy(_W(11, (64, 64)))
    scale = float(W.abs().max())

    def mean_err(ecc):
        gp, gn, s, _ = encode_core(W, torch.Generator().manual_seed(3),
                                   EPIRAM.g_levels, EPIRAM.sigma_program,
                                   ecc=ecc, stuck_rate=0.03)
        return float(((gp - gn) * s - W).abs().mean()) / scale

    assert mean_err(3) < mean_err(1) / 3


def test_drift_decays_the_programmed_array():
    W = torch.from_numpy(_W(4, (64, 64)))
    gp0, gn0, _, _ = encode_core(W, None, 256, 0.0)
    gp, gn, _, _ = encode_core(W, torch.Generator().manual_seed(0), 256,
                               0.0, drift=0.1)
    torch.testing.assert_close(gp, gp0 * 0.9, rtol=1e-15, atol=0)
    torch.testing.assert_close(gn, gn0 * 0.9, rtol=1e-15, atol=0)


def test_ecc_ledger_matches_reference(x64):
    rx = _ref_crossbar()
    ref_dev = dataclasses.replace(rx.EPIRAM, ecc=3)
    W = _W(13, (64, 64))
    ref, ref_led = _ref_encode(W, ref_dev)
    led = Ledger()
    enc = encode_matrix(torch.from_numpy(W), device_from_reference(ref_dev),
                        torch.Generator().manual_seed(0), ledger=led)
    assert_ledgers_equal(led, ref_led)
    assert enc.active_cells == ref.active_cells
    assert led.cells_written_ecc == 2 * 2 * 64 * 64


def test_ecc_rejects_bad_knobs():
    W = torch.ones((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="ecc_decode"):
        encode_core(W, None, 256, 0.01, ecc=3, ecc_decode_how="vote")
    with pytest.raises(ValueError, match="replication factor"):
        encode_core(W, None, 256, 0.01, ecc=0)


def test_taox_writes_cheaper_than_epiram():
    W = torch.from_numpy(_W(3, (64, 64)))
    led_e, led_t = Ledger(), Ledger()
    encode_matrix(W, EPIRAM, ledger=led_e)
    encode_matrix(W, TAOX_HFOX, ledger=led_t)
    assert led_t.write_energy_j < led_e.write_energy_j / 10
    assert led_t.write_latency_s < led_e.write_latency_s / 3


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
def test_array_mvm_on_reference_conductances(x64, use_kernel):
    import jax

    rx = _ref_crossbar()
    ref_dev = noiseless_device(rx.EPIRAM)
    W = _W(21, (80, 70))
    ref_arr = rx.CrossbarArray.program(W, ref_dev,
                                       key=jax.random.PRNGKey(2),
                                       use_kernel=use_kernel)
    arr = CrossbarArray(enc=from_reference_encoded(ref_arr.enc, "cpu"),
                        ledger=Ledger(), device=device_from_reference(ref_dev),
                        use_kernel=use_kernel)
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    for _ in range(3):
        v = rng.normal(size=70)
        np.testing.assert_allclose(arr.mvm(torch.from_numpy(v)).numpy(),
                                   np.asarray(ref_arr.mvm(v)), rtol=0,
                                   atol=1e-12)
    # the reference's ledger also holds the write of its programming
    for f in ("read_energy_j", "read_latency_s", "mvm_count"):
        assert getattr(arr.ledger, f) == getattr(ref_arr.ledger, f), f
    assert arr.ledger.mvm_count == 3
    # on CPU tensors the kernel path runs B6's plain version: no launch
    assert kernels.launch_counts()["crossbar_mvm"] == 0


def test_kernel_and_plain_paths_draw_the_same_read_noise():
    W = torch.from_numpy(_W(8, (50, 90)))
    v = torch.from_numpy(_W(9, (90,)))
    a = CrossbarArray.program(W, EPIRAM, seed=4, use_kernel=False)
    b = CrossbarArray.program(W, EPIRAM, seed=4, use_kernel=True)
    for _ in range(3):
        torch.testing.assert_close(a.mvm(v), b.mvm(v), rtol=1e-13,
                                   atol=1e-13)
    c = CrossbarArray.program(W, EPIRAM, seed=5)
    assert not torch.allclose(a.mvm(v), c.mvm(v), rtol=1e-6, atol=0)


def test_ledger_write_once_read_many():
    W = torch.from_numpy(_W(2, (80, 70)))
    led = Ledger()
    arr = CrossbarArray.program(W, EPIRAM, ledger=led)
    write_e = led.write_energy_j
    assert write_e > 0
    for i in range(5):
        arr.mvm(torch.from_numpy(_W(i, (70,))))
    assert led.write_energy_j == write_e
    assert led.mvm_count == 5
    assert 0 < led.read_energy_j / led.mvm_count < write_e / 10


def test_analog_linear_shapes_and_accuracy():
    W = _W(5, (24, 16))
    x = _W(6, (4, 16))
    y = analog_linear(x, W, device=TAOX_HFOX, torch_device="cpu").numpy()
    assert y.shape == (4, 24)
    clean = x @ W.T
    assert np.abs(y - clean).max() / np.abs(clean).max() < 0.05


@pytest.mark.parametrize("entry", ["analog_linear", "from_reference_encoded"])
def test_default_device_raises_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W = _W(5, (24, 16))
    call = {
        "analog_linear": lambda: analog_linear(W[:2], W, device=TAOX_HFOX),
        "from_reference_encoded": lambda: from_reference_encoded(
            encode_matrix(torch.from_numpy(W), TAOX_HFOX)),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# ------------------------------------------------- B6's plain version ---

B6_SHAPES = [(37, 300), (130, 257), (128, 128)]


def _b6_inputs(seed, R, C, dtype, lead=()):
    rng = np.random.default_rng(seed)
    gp = rng.uniform(0, 1, (*lead, R, C)).astype(dtype)
    gn = rng.uniform(0, 1, (*lead, R, C)).astype(dtype)
    v = rng.normal(size=(*lead, C)).astype(dtype)
    noise = (1e-3 * rng.normal(size=(*lead, R))).astype(dtype)
    return gp, gn, v, dtype(0.83), noise


@pytest.mark.parametrize("shape", B6_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_plain_crossbar_mvm_matches_pallas(x64, shape, dtype, tol):
    """Tolerance over the largest |output|: sums of up to 300 terms in
    another order than the reference's 128-column tiles."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops
    from repro.kernels.ref import crossbar_mvm_ref

    gp, gn, v, scale, noise = _b6_inputs(sum(shape), *shape, dtype)
    ref = np.asarray(ops.crossbar_mvm(gp, gn, v, scale, noise,
                                      interpret=True))
    oracle = np.asarray(crossbar_mvm_ref(
        gp, gn, v.reshape(-1, 1),
        (scale * (1.0 + jnp.asarray(noise))).reshape(-1, 1)))[:, 0]
    port = crossbar_mvm_plain(*(torch.from_numpy(a) for a in (gp, gn, v)),
                              scale, torch.from_numpy(noise))
    assert port.dtype == torch.from_numpy(gp).dtype
    top = np.abs(ref).max()
    assert np.abs(port.numpy() - ref).max() <= tol * top
    assert np.abs(port.numpy() - oracle).max() <= tol * top


def test_plain_crossbar_mvm_zero_padding_is_inert():
    gp, gn, v, scale, noise = _b6_inputs(1, 37, 300, np.float64)
    base = crossbar_mvm_plain(torch.from_numpy(gp), torch.from_numpy(gn),
                              torch.from_numpy(v), scale,
                              torch.from_numpy(noise))
    pad = lambda a, r, c: np.pad(a, ((0, r), (0, c)))  # noqa: E731
    padded = crossbar_mvm_plain(
        torch.from_numpy(pad(gp, 91, 84)), torch.from_numpy(pad(gn, 91, 84)),
        torch.from_numpy(np.pad(v, (0, 84))), scale,
        torch.from_numpy(np.pad(noise, (0, 91))))
    torch.testing.assert_close(padded[:37], base, rtol=1e-14, atol=1e-14)
    assert torch.all(padded[37:] == 0.0)


def test_crossbar_mvm_batch_axis_and_cpu_rule():
    gp, gn, v, _, noise = _b6_inputs(2, 20, 33, np.float64, lead=(3,))
    scale = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    t = [torch.from_numpy(a) for a in (gp, gn, v)]
    kernels.reset_launch_counts()
    out = crossbar_mvm(*t, scale, torch.from_numpy(noise))
    assert out.shape == (3, 20)
    for i in range(3):
        torch.testing.assert_close(
            out[i], crossbar_mvm_plain(t[0][i], t[1][i], t[2][i],
                                       float(scale[i]),
                                       torch.from_numpy(noise[i])),
            rtol=1e-14, atol=1e-14)
    assert kernels.launch_counts()["crossbar_mvm"] == 0
    meta = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="run on CUDA"):
        crossbar_mvm(meta, meta, torch.zeros(4, device="meta"), 1.0,
                     torch.zeros(4, device="meta"))
