"""Synthetic channels: point-target radar scene + multipath comm model.

JAX-native equivalent of ``target_simulator`` (lib/target_simulator_impl.cc)
plus the comm-sim channel (per-antenna ULA phase shifts + path loss + AWGN +
CFO, from examples/simulation/communication/mimo_ofdm_jrc_comm_sim.grc).
These are the "fake backends" that close both loops without hardware.

Radar model per target k and virtual element (tx, rx)
(lib/target_simulator_impl.cc:150-385):
  doppler   f_D = 2·v·f_c/c, applied as a time-domain phase ramp
  delay     τ = (2R − pos_virt·sin(az))/c, applied as exp(−j2πτ(f+f_c)) in
            the frequency domain over two-sided FFT bin frequencies
  amplitude A = c·√RCS / ((4π)^{3/2}·R²·f_c)  (radar equation)
  optional per-target random phase and TX→RX self-coupling.

All spectral work is the pair-form mixed-radix DFT (ops/cplx.dft): matmul
real matmul stages, no complex HLO — frame-length transforms included.

Deviation from the reference (deliberate): the reference *overwrites* the
output per target (volk multiply writes, never accumulates —
lib/target_simulator_impl.cc:341-369), so with >1 target only the last
survives; we sum target contributions, which is the physically correct
superposition.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from jrc.ops import cplx as cx

C_LIGHT = 299792458.0
FOUR_PI_CUBED_SQRT = float((4 * np.pi) ** 1.5)


@dataclass(frozen=True)
class Targets:
    """Static point-target scene (ranges m, velocities m/s, azimuths deg, RCS m²)."""

    ranges: tuple
    velocities: tuple
    azimuths: tuple
    rcs: tuple

    def __len__(self):
        return len(self.ranges)


def virtual_positions(n_tx: int, n_rx: int, wavelength: float, spacing: float = 0.5) -> np.ndarray:
    """(n_tx, n_rx) virtual-element positions in meters for the reference's
    λ/2 virtual ULA: TX elements spaced λ/2, RX elements spaced n_tx·λ/2, so
    the **rx-major** pair index rx·n_tx+tx walks the array linearly — matching
    the radar block's default rx-major channel ordering and the radar-sim
    grc's TXk_RXs = [(2+k)/2·λ, (2+k+4)/2·λ] geometry (constant offset
    dropped; it only adds a common phase)."""
    tx = np.arange(n_tx)[:, None]
    rx = np.arange(n_rx)[None, :]
    idx = rx * n_tx + tx
    return (idx * spacing * wavelength).astype(np.float32)


def apply_targets(
    tx_time: cx.CArray,  # (n_tx, n_samp)
    targets: Targets,
    *,
    sample_rate: float,
    center_freq: float,
    pos_virtual: np.ndarray,  # (n_tx, n_rx) meters
    rng_key=None,  # enables per-target random phase when given
    self_coupling_db: float | None = None,
    t0: float = 0.0,
) -> cx.CArray:
    """Propagate TX waveforms through the target scene → (n_rx, n_samp).

    ``t0`` is the stream time of the first sample: the Doppler phase ramp
    continues across successive calls exactly like the reference's streaming
    ``target_simulator`` (its per-sample filter runs over the unbroken
    stream, lib/target_simulator_impl.cc:280-286) — required for cross-dwell
    (slow-time) Doppler processing. The delay filter keeps the static range
    per call, as the reference does (range migration over a dwell sequence
    is ≪ a range bin at these scene dynamics).
    """
    tx_time = cx.from_complex(tx_time)
    n_tx, n = tx_time.shape
    n_rx = pos_virtual.shape[1]
    k = len(targets)

    rng_t = jnp.asarray(targets.ranges, jnp.float32)
    vel = jnp.asarray(targets.velocities, jnp.float32)
    az = jnp.asarray(targets.azimuths, jnp.float32)
    rcs = jnp.asarray(targets.rcs, jnp.float32)

    doppler = 2.0 * vel * center_freq / C_LIGHT  # (K,)
    ampl = C_LIGHT * jnp.sqrt(rcs) / FOUR_PI_CUBED_SQRT / rng_t**2 / center_freq

    t = jnp.float32(t0) + jnp.arange(n, dtype=jnp.float32) / sample_rate
    dopp_ramp = cx.expj(2 * jnp.pi * doppler[:, None] * t[None, :])  # (K, n)
    if rng_key is not None:
        phase = jax.random.uniform(rng_key, (k,), minval=0.0, maxval=2 * np.pi)
        dopp_ramp = dopp_ramp * cx.expj(phase)[:, None]
    dopp_ramp = dopp_ramp * ampl[:, None]

    # (n_tx, K, n): Doppler-shifted TX, then to frequency domain
    x = tx_time[:, None, :] * dopp_ramp[None, :, :]
    X = cx.dft(x)

    freqs = jnp.asarray(cx.fftfreq(n, d=1.0 / sample_rate))  # two-sided
    # τ per (tx, rx, K)
    tau = (
        2.0 * rng_t[None, None, :]
        - jnp.asarray(pos_virtual)[:, :, None] * jnp.sin(jnp.deg2rad(az))[None, None, :]
    ) / C_LIGHT
    shift = cx.expj(
        -2 * jnp.pi * tau[..., None] * (freqs + center_freq)[None, None, None, :]
    )  # (n_tx, n_rx, K, n)

    y = cx.dft(X[:, None, :, :] * shift, inverse=True)  # (n_tx, n_rx, K, n)
    rx = cx.sum(y, axis=(0, 2))  # (n_rx, n)

    if self_coupling_db is not None:
        coupling = 10.0 ** (self_coupling_db / 20.0)
        rx = rx + coupling * cx.sum(tx_time, axis=0)[None, :]
    return rx


def awgn(rng_key, x: cx.CArray, noise_var) -> cx.CArray:
    """Complex AWGN with total variance ``noise_var`` (var/2 per quadrature),
    matching the sim graphs' analog_noise_source with amplitude √noise_var."""
    x = cx.from_complex(x)
    kr, ki = jax.random.split(rng_key)
    std = jnp.sqrt(jnp.asarray(noise_var, jnp.float32) / 2.0)
    return x + cx.CArray(
        std * jax.random.normal(kr, x.shape, jnp.float32),
        std * jax.random.normal(ki, x.shape, jnp.float32),
    )


def thermal_noise_var(sample_rate: float, noise_figure_db: float = 5.0, temp_k: float = 290.0) -> float:
    """kTB·NF noise variance used by the sim flowgraphs' ``noise_var``."""
    k_boltz = 1.380649e-23
    return k_boltz * temp_k * sample_rate * 10.0 ** (noise_figure_db / 10.0)


def comm_channel(
    tx_time: cx.CArray,  # (n_tx, n_samp)
    *,
    angle_deg: float,
    path_loss: float,
    noise_var: float,
    cfo: float = 0.0,  # radians/sample
    rng_key=None,
) -> cx.CArray:
    """Comm-sim channel: ULA phase per TX antenna at ``angle_deg``, path-loss
    scaling, sum over antennas, CFO rotation, AWGN → (n_samp,).

    Mirrors the comm-sim flowgraph: multiply_const ``exp(j·k·π·sin θ)/path_loss``
    per antenna → add → channels_channel_model(freq_offset=cfo/2π per sample).
    """
    tx_time = cx.from_complex(tx_time)
    n_tx, n = tx_time.shape
    k = jnp.arange(n_tx)
    steer = cx.expj(jnp.pi * jnp.sin(jnp.deg2rad(jnp.asarray(angle_deg))) * k)
    y = cx.sum(tx_time * steer[:, None], axis=0) / path_loss
    if cfo:
        y = y * cx.expj(cfo * jnp.arange(n, dtype=jnp.float32))
    if rng_key is not None and noise_var > 0:
        y = awgn(rng_key, y, noise_var)
    return y
