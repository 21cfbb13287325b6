"""Mesh helpers, batch sharding, checkpoint/resume, profiling counters."""
import jax
import jax.numpy as jnp
import numpy as np

from jrc.config import MCS, OFDMConfig, PacketType
from jrc.parallel import mesh as pmesh
from jrc.parallel import batch as pbatch
from jrc.utils import state_io
from jrc.utils.profiling import Throughput

CFG = OFDMConfig()


def test_meshes():
    m = pmesh.time_mesh()
    assert m.devices.size == 8 and m.axis_names == ("time",)
    b = pmesh.batch_mesh(4)
    assert b.devices.size == 4
    g = pmesh.grid_mesh(2, 4)
    assert g.devices.shape == (4, 2) and g.axis_names == ("batch", "time")


def test_batched_range_angle_maps(rng):
    m = pmesh.batch_mesh(8)
    chans = (rng.normal(size=(8, 8, 64)) + 1j * rng.normal(size=(8, 8, 64))).astype(np.complex64)
    maps = pbatch.batched_range_angle_maps(m, jnp.asarray(chans))
    assert maps.shape == (8, 512, 128)
    # matches the single-map kernel
    from jrc.ops import radar

    one = np.abs(np.asarray(radar.range_angle_map(jnp.asarray(chans[3])))) ** 2
    np.testing.assert_allclose(np.asarray(maps[3]), one, rtol=1e-4, atol=1e-6)


def test_batched_rx(rng):
    from jrc.models import comm_link, streaming
    from jrc.ops import channel
    from jrc.ops.encoder import FrameSpec, make_payload

    spec = FrameSpec(MCS.QPSK_1_2, payload_bytes=24, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + b"batch"))
    tx = comm_link.tx_frame(CFG, spec, payload, 1)
    frame = np.asarray(channel.comm_channel(tx.samples, angle_deg=0.0,
                                            path_loss=5.0, noise_var=0.0))
    halo = streaming.frame_window_samples(CFG, spec) + 64
    block = 8192
    caps = np.zeros((8, block + halo), np.complex64)
    caps += (rng.normal(0, 1e-4, caps.shape) + 1j * rng.normal(0, 1e-4, caps.shape))
    n_per = []
    for i in range(8):
        n = 1 + i % 3
        pos = 300
        for _ in range(n):
            caps[i, pos : pos + len(frame)] += frame
            pos += len(frame) + 900
        n_per.append(n)
    m = pmesh.batch_mesh(8)
    counts = np.asarray(pbatch.batched_rx(m, CFG, spec, jnp.asarray(caps)))
    np.testing.assert_array_equal(counts[:, 0], n_per)
    np.testing.assert_array_equal(counts[:, 1], n_per)


def test_state_checkpoint_roundtrip(tmp_path):
    from jrc.models import jrc_trx

    st = jrc_trx.init_state(CFG)
    st = st._replace(radar_angle=jnp.float32(17.5), radar_valid=jnp.bool_(True),
                     frame_count=jnp.int32(42))
    p = str(tmp_path / "state.npz")
    state_io.save_state(p, st)
    back = state_io.load_state(p, jrc_trx.init_state(CFG))
    assert isinstance(back, jrc_trx.JRCState)
    assert float(back.radar_angle) == 17.5
    assert bool(back.radar_valid)
    assert int(back.frame_count) == 42
    assert back.background.buffer.shape == st.background.buffer.shape


def test_throughput_counter():
    t = Throughput()
    with t.measure(n_samples=1000, n_frames=2):
        pass
    assert t.samples == 1000 and t.frames == 2
    assert t.samples_per_sec > 0
    assert "Msamp/s" in t.report()


def test_checkpoint_resume_continues_jrc_loop_bit_exactly(tmp_path):
    """Resume-from-snapshot must be indistinguishable from an uninterrupted
    run: the JRCState npz is the complete cross-dwell state (the reference's
    restart-survivable CSV side files, SURVEY §5)."""
    from jrc.models import jrc_trx
    from jrc.ops import channel
    from jrc.ops.encoder import FrameSpec, make_payload
    from jrc.config import MCS, PacketType

    targets = channel.Targets((12.0,), (0.0,), (25.0,), (10.0,))
    spec = FrameSpec(MCS.QPSK_3_4, payload_bytes=64, packet_type=PacketType.DATA)
    payload = jnp.asarray(make_payload(spec, bytes([2]) + b"ckpt"))

    def run(state, dwell_indices):
        for d in dwell_indices:
            r = jrc_trx.jrc_step(CFG, state, spec, payload, targets,
                                 key=jax.random.PRNGKey(d), comm_noise_var=1e-4)
            state = r.state
        return state, r

    # uninterrupted 4 dwells
    s_ref, r_ref = run(jrc_trx.init_state(CFG), range(4))

    # 2 dwells → snapshot → fresh process state → resume 2 more
    s_half, _ = run(jrc_trx.init_state(CFG), range(2))
    p = str(tmp_path / "jrc.npz")
    state_io.save_state(p, s_half)
    resumed = state_io.load_state(p, jrc_trx.init_state(CFG))
    s_res, r_res = run(resumed, range(2, 4))

    np.testing.assert_array_equal(np.asarray(s_ref.radar_angle),
                                  np.asarray(s_res.radar_angle))
    np.testing.assert_array_equal(np.asarray(s_ref.frame_count),
                                  np.asarray(s_res.frame_count))
    np.testing.assert_array_equal(np.asarray(s_ref.background.buffer.re),
                                  np.asarray(s_res.background.buffer.re))
    assert bool(np.asarray(r_res.comm.decoded.crc_ok)) == \
        bool(np.asarray(r_ref.comm.decoded.crc_ok))
    np.testing.assert_array_equal(np.asarray(r_ref.comm.decoded.payload),
                                  np.asarray(r_res.comm.decoded.payload))
