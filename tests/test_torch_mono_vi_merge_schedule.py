"""The inertial mapper's schedule across Atlas maps: tpuslam's faults and
the port's repair, on the CPU, in both packages.

tpuslam keeps the IMU schedule on the mapper (the time of the IMU init, the
VIBA stage, the last scale refinement: `LocalMapper.imu_init_time`,
`viba_stage`, `_last_refine`) and one set of IMU flags on the store for the
whole Atlas. ORB-SLAM3 keeps them on each Map. The port keeps them on each
map (map/store.py): a new map starts with none; a merged map goes on with
the schedule of the map further behind in it (the VIBAs that either map has
not run then run over both) and runs no scale refinement (one scale for
both sessions would rescale the one whose scale has converged). Two cases
of the mono-inertial multi-session route, each driven through the mapper's
own `_imu_stage` on keyframes stamped as the sessions stamp them, with the
solves replaced by stand-ins that record the call (the IMU init sets the
flag; a scale refinement rescales the current map by REFINE_SCALE, as the
real one rescales it by what it solves):

  * a second session whose clock starts before the first map's last scale
    refinement (two recordings stamped each from 0): tpuslam's young map
    compares its keyframes' stamps with the old map's last refinement and
    skips its own refinements; the port's young map refines at its period,
    on the stamps the first map refined at;
  * a refinement due after a merge made while the young map is before its
    VIBA2 and the merge map after it: tpuslam's merged map refines, and the
    refinement rescales the merge map's converged keyframes too; the port's
    merged map goes on with the young map's stage but does not refine, and
    no keyframe of the merge map moves.

And the case of phase 16 b async's route (tests/test_torch_async_vi_merge_lags.py):
the merge map behind the young one (A at VIBA1, the young map at VIBA2):
tpuslam's merged map goes on at the young map's VIBA2 and never runs the
VIBA2 that A's keyframes missed; the port's runs it over both sessions.

The store's part of the repair, on its own: create_new_map keeps the old
map's state, relabel_map hands the merged map the state of the map further
behind, with its times carried onto the young map's clock.
"""

import numpy as np
import pytest
import torch

import tpuslam.engine.inertial as j_inertial
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine.config import InertialConfig as JInertialConfig
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.local_mapping import LocalMapper as JLocalMapper
from tpuslam.imu.preintegration import ImuCalib as JImuCalib
from tpuslam.map.store import SlamMap as JSlamMap
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import local_mapping
from tpuslam_torch.engine.config import InertialConfig, SlamConfig
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.map.store import IMU_STATE, SlamMap

from torch_vi_merge import NOISE, SHORT_SCHEDULE

torch.set_num_threads(2)
PACKAGES = ("port", "tpuslam")
KF_DT = 0.3                 # a keyframe every 3 frames at 10 fps
REFINE_SCALE = 1.05
CAMERA = ([200.0, 200.0, 188.0, 120.0], 376, 240)


class _Route:
    """One package's store and mapper, keyframes added by hand, the solves
    replaced by stand-ins that record [(map id, stamp, refinement?)]."""

    def __init__(self, pkg, mp, schedule):
        self.pkg, self.calls = pkg, []
        if pkg == "port":
            self.m = SlamMap(64)
            cfg = SlamConfig(inertial=InertialConfig(**schedule))
            self.lm = LocalMapper(Pinhole(*CAMERA), cfg, self.m, imu_calib=ImuCalib(**NOISE),
                                  mono=True, device="cpu")
            mp.setattr(local_mapping, "run_imu_init", self._init)
            mp.setattr(local_mapping, "full_inertial_ba", lambda *a, **kw: None)
        else:
            self.m = JSlamMap(64)
            cfg = JSlamConfig(inertial=JInertialConfig(**schedule))
            self.lm = JLocalMapper(JPinhole(*CAMERA), cfg, self.m,
                                   imu_calib=JImuCalib(**NOISE), mono=True)
            mp.setattr(j_inertial, "run_imu_init", self._init)
            mp.setattr(j_inertial, "full_inertial_ba", lambda *a, **kw: None)
        self.rng = np.random.default_rng(0)

    def _init(self, m, *a, opt_bias=True, **kw):
        chain = m.temporal_chain()
        self.calls.append((int(m.current_map_id), round(float(m.kf_time[chain[-1]]), 6),
                           not opt_bias))
        if opt_bias:
            m.imu_initialized = True
        else:
            m.apply_scaled_rotation(np.eye(3), REFINE_SCALE)
        return True

    def keyframe(self, t):
        """A keyframe of the current map at stamp t, then the mapper's IMU
        stage on it."""
        m = self.m
        k = m.n_kf
        m.n_kf += 1
        m.kf_valid[k], m.kf_time[k], m.kf_map_id[k] = True, t, m.current_map_id
        m.kf_R[k], m.kf_t[k] = np.eye(3), self.rng.normal(size=3)
        m.kf_prev[k] = k - 1 if k and m.kf_map_id[k - 1] == m.current_map_id else -1
        self.lm._imu_stage(k)
        return k

    def session(self, t0, n):
        return [self.keyframe(round(t0 + i * KF_DT, 6)) for i in range(n)]

    def refinements(self, map_id=None):
        return [t for mid, t, ref in self.calls if ref and (map_id is None or mid == map_id)]


def _clock_route(pkg):
    """Two sessions of 21 keyframes (6 s), each stamped from 0, the default
    schedule (init after 10 keyframes over 2 s, a refinement at most every
    1.5 s until VIBA2 at 15 s)."""
    with pytest.MonkeyPatch.context() as mp:
        r = _Route(pkg, mp, {})
        r.session(0.0, 21)
        r.m.create_new_map()
        r.session(0.0, 21)
    return r


def _merge_route(pkg):
    """A's 14 keyframes from 0 under SHORT_SCHEDULE (init, a refinement,
    VIBA1, VIBA2); B's first 10 from 100 s (its IMU init on the last); the
    merge there (the young map relabelled into A's, as
    LoopCloser._correct_loop does); then B's next keyframe. Returns the
    route and A's keyframe poses just after the merge."""
    with pytest.MonkeyPatch.context() as mp:
        r = _Route(pkg, mp, SHORT_SCHEDULE)
        a_kfs = r.session(0.0, 14)
        r.m.create_new_map()
        r.session(100.0, 10)
        r.stage_at_merge = r.lm.viba_stage
        r.m.relabel_map(1, 0)
        before = {k: r.m.kf_t[k].copy() for k in a_kfs}
        r.keyframe(100.0 + 10 * KF_DT)
    return r, before


def _behind_route(pkg):
    """A's 12 keyframes from 0 under SHORT_SCHEDULE (init, a refinement,
    VIBA1); B's 14 from 100 s (init, a refinement, VIBA1, VIBA2); the merge;
    then B's next 4 keyframes. Returns the IMU events after the merge."""
    with pytest.MonkeyPatch.context() as mp:
        r = _Route(pkg, mp, SHORT_SCHEDULE)
        r.session(0.0, 12)
        r.m.create_new_map()
        r.session(100.0, 14)
        n = len(r.lm.debug_events)
        r.m.relabel_map(1, 0)
        r.session(100.0 + 14 * KF_DT, 4)
    return [(e["event"], round(e["t"], 6)) for e in r.lm.debug_events[n:]]


@pytest.fixture(scope="module")
def clock():
    return {pkg: _clock_route(pkg) for pkg in PACKAGES}


@pytest.fixture(scope="module")
def merge():
    return {pkg: _merge_route(pkg) for pkg in PACKAGES}


def test_tpuslam_skips_the_young_maps_refinements(clock):
    r = clock["tpuslam"]
    assert r.refinements(0) == [3.0, 4.8]
    assert [t for mid, t, ref in r.calls if mid == 1 and not ref] == [2.7]   # B's IMU init
    # B's stamps restart at 0: each is measured against A's last refinement
    # (4.8 s), so B refines no time in its 6 s
    assert r.refinements(1) == []


def test_the_port_refines_the_young_map_at_its_period(clock):
    r = clock["port"]
    assert r.refinements(0) == [3.0, 4.8]
    assert r.refinements(1) == r.refinements(0)
    assert (r.m.imu_init_time, r.m.viba_stage, r.m.last_refine) == (2.7, 1, 4.8)


def test_tpuslam_rescales_the_merge_maps_keyframes(merge):
    r, before = merge["tpuslam"]
    assert r.stage_at_merge == 1 and r.m.inertial_ba2 is False
    # the merged map (A's id) ran the young map's schedule: a refinement
    # over both sessions' keyframes, which rescaled A's
    assert r.refinements(0) == [3.0, 103.0]
    for k, t_before in before.items():
        np.testing.assert_allclose(r.m.kf_t[k], REFINE_SCALE * t_before)


def test_the_port_does_not_rescale_the_merge_maps_keyframes(merge):
    r, before = merge["port"]
    assert r.stage_at_merge == 1
    # the merged map goes on with B's stage (further behind than A's VIBA2):
    # the refinement due on B's next keyframe runs its full inertial BA but
    # not the rescale, and A's keyframes keep their poses
    assert r.refinements() == [3.0]
    m = r.m
    assert (m.imu_initialized, m.inertial_ba1, m.inertial_ba2, m.viba_stage, m.merged) == (
        True, False, False, 1, True)
    assert m.last_refine == pytest.approx(103.0)
    for k, t_before in before.items():
        assert np.array_equal(m.kf_t[k], t_before), k


def test_tpuslam_skips_the_merge_maps_missing_viba2():
    assert _behind_route("tpuslam") == []


def test_the_port_runs_the_merge_maps_missing_viba2():
    # A's VIBA1 at 3.3 s, carried onto B's clock by 100.6 s (B's last
    # keyframe at 103.9 against A's at 3.3): VIBA2 due 1.0 s after A's init
    # (2.7 + 100.6), on B's keyframe at 104.5
    assert _behind_route("port") == [("viba2", 104.5)]


def _two_maps(stage_a, stage_b):
    """A store with map 0 (keyframes at 0, 1, 2 s) at stage_a and map 1
    (100, 101, 102.5 s) at stage_b, map 1 current; each map's IMU init 1 s
    after its first keyframe, its last refinement 0.5 s after that."""
    m = SlamMap(64)
    for k, t in enumerate((0.0, 1.0, 2.0, 100.0, 101.0, 102.5)):
        if k == 3:
            m.create_new_map()
        m.n_kf += 1
        m.kf_valid[k], m.kf_time[k], m.kf_map_id[k] = True, t, m.current_map_id
        if k in (2, 5):
            t0 = m.kf_time[k - 2]
            stage = stage_a if k == 2 else stage_b
            m.imu_initialized, m.inertial_ba1, m.inertial_ba2 = True, stage >= 2, stage >= 3
            m.imu_init_time, m.viba_stage, m.last_refine = t0 + 1.0, stage, t0 + 1.5
    return m


def test_the_store_keeps_each_maps_imu_state():
    m = _two_maps(2, 3)
    assert m.current_map_id == 1 and m.n_maps_created == 2
    assert m.map_imu == {0: dict(imu_initialized=True, inertial_ba1=True, inertial_ba2=False,
                                 imu_init_time=1.0, viba_stage=2, last_refine=1.5,
                                 merged=False)}
    assert m.imu_state_of(0)["viba_stage"] == 2 and m.imu_state_of(1)["viba_stage"] == 3
    assert set(m.imu_state_of(0)) == set(IMU_STATE)
    # A is further behind (VIBA1 only): the merged map takes A's state, its
    # stamps carried by 100.5 s (B's last keyframe at 102.5 against A's at
    # 2.0): 1 s after its init, 0.5 s after its refinement
    m.relabel_map(1, 0)
    assert m.current_map_id == 0 and m.map_imu == {} and m.map_ids() == [0]
    assert (m.imu_initialized, m.inertial_ba1, m.inertial_ba2, m.viba_stage, m.merged) == (
        True, True, False, 2, True)
    assert m.imu_init_time == pytest.approx(101.5) and m.last_refine == pytest.approx(102.0)
    # B further behind: the merged map goes on with B's own state
    m = _two_maps(3, 1)
    m.relabel_map(1, 0)
    assert (m.inertial_ba1, m.inertial_ba2, m.viba_stage, m.merged) == (False, False, 1, True)
    assert (m.imu_init_time, m.last_refine) == (101.0, 101.5)
    # a new map starts with no IMU state
    m.create_new_map()
    assert (m.imu_initialized, m.inertial_ba1, m.inertial_ba2, m.imu_init_time, m.viba_stage,
            m.last_refine, m.merged) == (False, False, False, None, 0, -1e9, False)
