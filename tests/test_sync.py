"""Frame detection and LTF synchronization."""
import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.ops import sync, ofdm, cplx as cx
from jrc.ops.encoder import FrameSpec
from jrc.models import comm_link


def _frame_samples(cfg, seed=0, pad_front=400):
    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=50, packet_type=PacketType.DATA)
    payload = jnp.zeros(50, jnp.uint8).at[0].set(2)
    tx = comm_link.tx_frame(cfg, spec, payload, 1, pad_front=pad_front, pad_tail=200,
                            rng_key=jax.random.key(seed))
    # single-antenna sum (all antennas at broadside)
    return cx.sum(tx.samples, axis=0), spec


def test_moving_sum_matches_numpy(rng):
    x = rng.normal(size=50).astype(np.float32)
    got = np.asarray(sync.moving_sum(jnp.asarray(x), 8))
    want = np.array([x[max(0, n - 7) : n + 1].sum() for n in range(50)])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_run_lengths():
    m = jnp.asarray([0, 1, 1, 1, 0, 1, 1, 0, 0, 1], bool)
    got = np.asarray(sync._run_lengths(m))
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 0, 1, 2, 0, 0, 1])


def test_detect_frame_in_stf(rng):
    cfg = OFDMConfig()
    x, _ = _frame_samples(cfg)
    det = sync.detect_frames(cfg, x, max_frames=4)
    assert bool(det.valid[0])
    # trigger must land inside the STF (frame body starts at 400)
    assert 400 <= int(det.start[0]) < 400 + 2 * cfg.sym_len
    assert not bool(det.valid[1])  # only one frame present
    assert abs(float(det.coarse_cfo[0])) < 1e-3  # no CFO injected


def test_detect_cfo_estimate(rng):
    cfg = OFDMConfig()
    x, _ = _frame_samples(cfg)
    cfo = 0.003
    n = jnp.arange(x.shape[0])
    det = sync.detect_frames(cfg, x * jnp.exp(1j * cfo * n), max_frames=1)
    assert bool(det.valid[0])
    assert abs(float(det.coarse_cfo[0]) - cfo) < 2e-4


def test_two_frames_detected(rng):
    cfg = OFDMConfig()
    x, _ = _frame_samples(cfg)
    gap = cx.zeros(1000)
    xx = cx.concatenate([x, gap, x])
    det = sync.detect_frames(cfg, xx, max_frames=4)
    assert bool(det.valid[0]) and bool(det.valid[1])
    assert int(det.start[1]) - int(det.start[0]) == x.shape[0] + 1000
    assert not bool(det.valid[2])


def test_ltf_sync_finds_peak_pair(rng):
    cfg = OFDMConfig()
    x, spec = _frame_samples(cfg)
    det = sync.detect_frames(cfg, x, max_frames=1)
    n_sym = 2 + 1 + cfg.n_ltf + spec.n_ofdm_sym
    x_padded = cx.concatenate([x, cx.zeros(1000)])
    syms, cfo, found = sync.extract_frame(cfg, x_padded, det.start[0], det.coarse_cfo[0], n_sym)
    assert bool(found)
    # the two LTF symbols must FFT to ltf·H with H ≈ const ⇒ symbol 0 ≈ symbol 1
    f = np.asarray(ofdm.fft_symbols(cfg, syms))
    active = cfg.active_carrier_idx
    np.testing.assert_allclose(f[0][active], f[1][active], atol=1e-3)
    # and dividing by the LTF sequence gives a flat channel
    h = f[0][active] / cfg.lltf_freq[active]
    assert np.std(np.abs(h)) / np.mean(np.abs(h)) < 0.01


def test_gap_tolerant_triggers_unit():
    # peaks with a dip: 12 peaks within 40 samples but never 10 consecutive
    m = np.zeros(200, bool)
    peaks = [10, 11, 12, 13, 14, 16, 17, 18, 19, 20, 22, 23]
    m[peaks] = True
    trig = np.asarray(sync._gap_tolerant_triggers(jnp.asarray(m), 10, 160))
    # trigger at the 11th peak (index 22); every later peak also satisfies it
    assert trig[22] and trig[23]
    assert not trig[:22].any()
    # strict runs never reach 10
    assert int(np.max(np.asarray(sync._run_lengths(jnp.asarray(m))))) < 10


def test_gap_tolerant_survives_impulsive_interference(rng):
    """A short interference burst mid-STF dents the normalized correlation
    (the impulse inflates the power normalizer) — the reference's
    gap-tolerant counter (lib/frame_detector_impl.cc:89-134) rides through
    it, strict consecutive runs are broken every time."""
    cfg = OFDMConfig()
    x, _ = _frame_samples(cfg)
    xn = np.asarray(x).copy()
    stf_lo, stf_hi = 400, 400 + 2 * cfg.sym_len + cfg.fft_len
    amp = 8 * np.sqrt(np.mean(np.abs(xn[400:560]) ** 2))
    # impulses spaced so every min_n_peaks=10 window of the plateau is hit
    for pos in range(stf_lo + 20, stf_hi, 55):
        xn[pos] += amp * np.exp(2j * np.pi * rng.random())
    d = sync.detect_frames(cfg, jnp.asarray(xn), max_frames=2)
    assert bool(d.valid[0]) and stf_lo <= int(d.start[0]) < stf_hi, (
        np.asarray(d.start), np.asarray(d.valid))
    d = sync.detect_frames(cfg, jnp.asarray(xn), max_frames=2, strict_runs=True)
    strict_hit = bool(d.valid[0]) and stf_lo <= int(d.start[0]) < stf_hi
    assert not strict_hit, np.asarray(d.start)


def test_detection_probability_low_snr(rng):
    """Detection-probability-vs-SNR: near the threshold SNR the gap-tolerant
    counter must never do worse than strict runs, and must still catch most
    frames where the correlation hovers at the 0.6 threshold."""
    cfg = OFDMConfig()
    x, _ = _frame_samples(cfg)
    xn = np.asarray(x)
    sig_pow = np.mean(np.abs(xn[400:560]) ** 2)  # STF region power
    snr_db = 0.5
    noise_std = float(np.sqrt(sig_pow / 10 ** (snr_db / 10) / 2))
    n_trials, hits_gap, hits_strict = 40, 0, 0
    det_gap = jax.jit(lambda v: sync.detect_frames(cfg, v, max_frames=2))
    det_strict = jax.jit(
        lambda v: sync.detect_frames(cfg, v, max_frames=2, strict_runs=True)
    )
    for t in range(n_trials):
        noise = (rng.normal(size=xn.shape) + 1j * rng.normal(size=xn.shape)
                 ).astype(np.complex64) * noise_std
        v = jnp.asarray(xn + noise)
        stf_lo, stf_hi = 400, 400 + 2 * cfg.sym_len + cfg.fft_len
        d = det_gap(v)
        if bool(d.valid[0]) and stf_lo <= int(d.start[0]) < stf_hi:
            hits_gap += 1
        d = det_strict(v)
        if bool(d.valid[0]) and stf_lo <= int(d.start[0]) < stf_hi:
            hits_strict += 1
    assert hits_gap >= hits_strict, (hits_gap, hits_strict)
    assert hits_gap >= 0.6 * n_trials, (hits_gap, n_trials)


def test_gap_tolerant_matches_anchor_rule(rng):
    """The moving-sum formulation must reproduce the reference SEARCH-counter
    anchor rule (lib/frame_detector_impl.cc:89-134) exactly: trigger at a
    peak when the (count-min_n_peaks)-th peak lies < max_peak_distance
    behind it."""
    for trial in range(20):
        m = rng.random(600) < rng.choice([0.05, 0.3, 0.8])
        got = np.asarray(sync._gap_tolerant_triggers(jnp.asarray(m), 10, 160))
        pos = np.flatnonzero(m)
        want = np.zeros_like(m)
        for k, i in enumerate(pos):  # k is 0-based peak number
            if k >= 10 and i - pos[k - 10] < 160:
                want[i] = True
        np.testing.assert_array_equal(got, want)
