"""scripts/vi_f32_experiment_torch.py, tpuslam's f32 visual-inertial run,
on the CPU: its lines, its --stereo, and tpuslam's --stereo fault (the
script cases of tests/test_torch_vi_schedule.py, in a file of their own so
that they run beside that file's lockstep).

  * The port's script on the CPU (f32): its lines in tpuslam's formats, and
    --stereo on the heave trajectory (tests/torch_vi_heave.py), which
    initializes stereo tracking.
  * tpuslam's script's --stereo fault: on its own vi_excite sequence an
    IMU_STEREO System never passes the stereo-inertial init gate, so it
    never starts tracking, in tpuslam and in the port alike.
"""

import os
import re
import sys

import numpy as np
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.imu.preintegration import ImuCalib as JImuCalib
from tpuslam.io.synthetic import SyntheticSequence as JSyntheticSequence
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.io.synthetic import SyntheticSequence

from test_torch_vi_schedule import _config
from test_torch_vi_system import NOISE, _imu
from torch_vi_heave import HeaveTrajectory

torch.set_num_threads(2)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import vi_f32_experiment_torch as script  # noqa: E402


FORMATS = [
    # tpuslam's f-strings (scripts/vi_f32_experiment.py:82-99)
    r"frame [ \d]{3}\d t=[ \d]{2}\d\.\d\ds state=[A-Z_]+ +ate=[ \d]{2}\d\.\d{4} "
    r"scale=[ \d-]\d\.\d{3} kfs=\d+",
    r"",
    r"FINAL: \d+ frames in \d+\.\ds \(\d+\.\d fps\) state=[A-Z_]+",
    r"ATE scaled=\d+\.\d{4} \(scale \d+\.\d{3}\)  unscaled=\d+\.\d{4} kfs=\d+ traj_rows=\d+",
    r"RESULT: (PASS|FAIL)",
    # the port's own lines
    r"imu event \w+ +t= *\d+\.\d\ds frame= *\d+ kfs=\d+",
    r"scale refinements \d+; local inertial BAs with zero priors \d+; IMU initialized after "
    r"frame -?\d+",
    r"max \|R\^T R - I\| over \d+ keyframes \d\.\d{3}e[-+]\d\d",
    r"stage \w+ +n= *\d+ median +\d+\.\d ms  max +\d+\.\d ms",
    r"launches per frame: patch gather \d+\.\d{3}, pose LM \d+\.\d{3}; on \d+ fused VI frames: "
    r"patch gather \[[\d, ]*\], pose LM \[[\d, ]*\], pose_inertial_solve \[[\d, ]*\]",
]


def test_script_prints_tpuslam_lines(capsys):
    assert script.main(["--frames", "20", "--device", "cpu"]) in (0, 1)
    lines = capsys.readouterr().out.splitlines()
    for line in lines:
        assert any(re.fullmatch(f, line) for f in FORMATS), line
    kinds = [next(k for k, f in enumerate(FORMATS) if re.fullmatch(f, ln)) for ln in lines]
    # frame 20's line, the script's own lines, then tpuslam's closing lines
    assert kinds[0] == 0 and kinds[-4:] == [1, 2, 3, 4], kinds
    assert min(kinds[1:-4]) >= 5, kinds
    assert "state=OK" in lines[0] and lines[-3].endswith("state=OK"), lines


def test_script_stereo_takes_the_heave_trajectory():
    # the heave passes the stereo-inertial init gate by frame 3
    res = script.run(10, stereo=True, device="cpu", log=lambda s: None)
    assert isinstance(res["seq"].traj, HeaveTrajectory)
    assert res["state"] == "OK" and len(res["traj"]) >= 6, (res["state"], len(res["traj"]))
    # over the full run's 22 s the heaving camera stays over 0.5 m from
    # every wall of the 10 x 6 x 4 m room
    seq = script.sequence(220, stereo=True)
    pos = seq.traj.pos(seq.timestamps())
    assert min(pos.min(), (np.asarray(seq.traj.room) - pos).min()) > 0.5


def _stereo_imu_states(slam, seq):
    times, states = seq.timestamps(), []
    for i in range(seq.n_frames):
        slam.track_stereo(seq.frame(i), seq.frame(i, right=True), times[i],
                          imu=_imu(seq, times, i))
        states.append(slam.get_tracking_state().name)
    return states


def test_reference_stereo_script_never_initializes_on_vi_excite():
    """tpuslam's `vi_f32_experiment.py --stereo`: its IMU_STEREO System on
    its own vi_excite sequence (std |a| 0.0114 m/s^2) waits at the
    stereo-inertial init gate (0.25 m/s^2) on every frame, so tracking never
    starts (the state stays NO_IMAGES_YET, no keyframe, no trajectory row),
    in tpuslam and in the port, which share the gate. The port's script
    takes the heave trajectory instead, which passes the gate by frame 3, so
    n frames show the fault."""
    n = 8
    kw = dict(n_frames=n, fps=10, speed=0.3, imu_rate=200.0, kind="vi_excite", baseline=0.1)
    jseq, tseq = JSyntheticSequence(**kw), SyntheticSequence(**kw)
    jcfg, tcfg = _config()
    cam, bf = [tseq.fx, tseq.fy, tseq.cx, tseq.cy], tseq.fx * tseq.baseline
    js = JSystem(JPinhole(cam, jseq.width, jseq.height), jcfg, sensor=JSensor.IMU_STEREO,
                 imu_calib=JImuCalib(**NOISE), bf=bf)
    ts = System(Pinhole(cam, tseq.width, tseq.height), tcfg, sensor=Sensor.IMU_STEREO,
                imu_calib=ImuCalib(**NOISE), bf=bf, device="cpu")
    waiting = ["NO_IMAGES_YET"] * n
    assert _stereo_imu_states(js, jseq) == waiting
    assert js.trajectory_tum() == [] and len(js.map.valid_kf_ids()) == 0
    assert _stereo_imu_states(ts, tseq) == waiting
    assert ts.trajectory_tum() == [] and len(ts.map.valid_kf_ids()) == 0
    accs = np.concatenate([jseq.imu_between(a, b)[2] for a, b in zip(jseq.timestamps()[:-1],
                                                                      jseq.timestamps()[1:])])
    assert np.std(np.linalg.norm(accs, axis=1)) < 0.25
