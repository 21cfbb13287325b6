"""Full-frame TX waveform golden: any wire-format drift fails here.

tests/golden_tx_frames.npz pins complete 4-antenna time-domain frames
(NDP + DATA; Fourier / per-sc phased / mean-SVD steering / radar streams —
frame layout /root/reference/lib/mimo_precoder_impl.cc:271-293, pinned by
scripts/pin_tx_golden.py). Two layers of defense:

1. **structural audit of the stored header** — invariants checked on the
   npz itself, independent of the TX code: frame-length math, preamble/SIG
   confined to the first 2 antennas, STF periodicity, cyclic-prefix
   structure, and full RX decodability (SIG fields, CRC, payload bytes);
2. **bit-drift comparison** — the live TX chain must reproduce each stored
   waveform.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.models import comm_link
from jrc.ops import channel, cplx as cx, precoder

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden_tx_frames.npz"))
CFG = OFDMConfig()
CASES = ["data_fourier", "data_steered_phased", "data_mean_svd",
         "data_radar_streams", "ndp"]


def _spec(name):
    from jrc.ops.encoder import FrameSpec

    return FrameSpec(
        MCS(int(GOLD[f"{name}_mcs"])),
        payload_bytes=int(GOLD[f"{name}_payload_bytes"]),
        packet_type=PacketType(int(GOLD[f"{name}_ptype"])),
    )


def test_golden_numerology_matches_config():
    assert int(GOLD["fft_len"]) == CFG.fft_len
    assert int(GOLD["cp_len"]) == CFG.cp_len
    assert int(GOLD["n_tx"]) == CFG.n_tx
    assert int(GOLD["n_ltf"]) == CFG.n_ltf
    assert int(GOLD["n_sync_words"]) == CFG.n_sync_words


@pytest.mark.parametrize("name", CASES)
def test_golden_frame_length_math(name):
    """n_samples = (n_sync + SIG + n_ltf + n_data_sym)·(fft+cp),
    lib/utils.cc:26-53 + lib/mimo_precoder_impl.cc:271-293."""
    w = GOLD[f"{name}_wave"]
    n_sym = CFG.n_sync_words + 1 + CFG.n_ltf + int(GOLD[f"{name}_n_ofdm_sym"])
    assert w.shape == (CFG.n_tx, n_sym * CFG.sym_len)


@pytest.mark.parametrize("name", CASES)
def test_golden_preamble_on_first_two_antennas(name):
    """Legacy preamble + SIG exist only on antennas 0/1
    (lib/mimo_precoder_impl.cc:342,359)."""
    w = GOLD[f"{name}_wave"]
    head = (CFG.n_sync_words + 1) * CFG.sym_len
    assert np.abs(w[2:, :head]).max() == 0.0
    # and are actually present on antennas 0 and 1
    assert np.abs(w[0, :head]).max() > 0.1
    assert np.abs(w[1, :head]).max() > 0.1


@pytest.mark.parametrize("name", CASES)
def test_golden_stf_periodicity(name):
    """The STF is period-(fft_len/4) in time — the property the
    Schmidl-Cox autocorrelation detector keys on (comm-sim delay fft/4)."""
    w = GOLD[f"{name}_wave"][0]
    body = w[CFG.cp_len : CFG.sym_len]  # first STF symbol, CP stripped
    q = CFG.fft_len // 4
    np.testing.assert_allclose(body[q:], body[:-q], atol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_golden_cyclic_prefix_structure(name):
    """Every symbol's CP equals its body tail on every antenna."""
    w = GOLD[f"{name}_wave"]
    n_sym = w.shape[-1] // CFG.sym_len
    syms = w.reshape(CFG.n_tx, n_sym, CFG.sym_len)
    np.testing.assert_allclose(
        syms[..., : CFG.cp_len], syms[..., -CFG.cp_len :], atol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_golden_decodes_end_to_end(name):
    """The stored waveform is a real frame: through a clean channel the RX
    recovers the SIG header fields, a clean CRC, and the exact payload."""
    spec = _spec(name)
    w = jnp.asarray(GOLD[f"{name}_wave"])
    lead = np.zeros(600, np.complex64)
    rx = np.asarray(channel.comm_channel(
        cx.from_complex(w), angle_deg=0.0, path_loss=4.0, noise_var=0.0))
    stream = np.concatenate([lead, rx, np.zeros(5 * CFG.sym_len, np.complex64)])
    res = comm_link.rx_chain(CFG, spec, jnp.asarray(stream))
    assert bool(res.sync_found)
    assert bool(res.eq.sig_ok)
    assert int(res.eq.sig_ptype) == (1 if spec.packet_type is PacketType.DATA
                                     else 0)
    assert int(res.eq.sig_length) == spec.payload_bytes + 4
    assert bool(res.decoded.crc_ok)
    np.testing.assert_array_equal(
        np.asarray(res.decoded.payload), GOLD[f"{name}_payload"])


def test_live_tx_matches_golden():
    """Regenerate every case through the live TX chain — any drift in the
    encoder, precoder, steering math, IFFT scaling, or CP insertion fails."""
    import jax

    from scripts.pin_tx_golden import build_cases

    _cfg, out, meta = build_cases()
    for name in CASES:
        np.testing.assert_allclose(
            out[f"{name}_wave"], GOLD[f"{name}_wave"], atol=2e-6,
            err_msg=f"wire-format drift in case {name!r} — if intentional, "
                    "re-pin with scripts/pin_tx_golden.py")
        np.testing.assert_array_equal(meta[f"{name}_payload"],
                                      GOLD[f"{name}_payload"])
