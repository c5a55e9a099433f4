"""A rendered sequence that passes the stereo-inertial init gate.

The stereo-inertial tracker waits until the std of |a| over the raw
accelerometer samples reaches 0.25 m/s^2. The renderer's own trajectory
kinds never do: `vi_excite`'s wobble is lateral, so |a| stays close to g
(std 0.0114 m/s^2). `HeaveTrajectory` adds a vertical heave,
z += amplitude * sin(omega * t), to a renderer trajectory; at the default
0.10 m and 4 rad/s the peak vertical acceleration is 1.6 m/s^2, about the
excitation of a EuRoC MAV, and the gate passes on frame 2 at 10 fps and
frame 3 at 20 fps. Over the first 5.5 s the camera stays at z in
2.12-2.40 m, well inside the 4 m room.

`heave_sequence(**kw)` is the port's SyntheticSequence with its `traj`
replaced by a HeaveTrajectory, so images, ground truth and IMU samples all
follow the heaving path. Both the port's tests and chip_smoke.py import
this module (chip_smoke.py puts tests/ on sys.path), so it imports only
the port and numpy.
"""

import numpy as np

from tpuslam_torch.io.synthetic import SyntheticSequence, Trajectory

HEAVE_AMPLITUDE = 0.10   # m
HEAVE_OMEGA = 4.0        # rad/s


class HeaveTrajectory(Trajectory):
    """`kind`'s trajectory plus z = amplitude * sin(omega * t), with the
    closed-form velocity and acceleration of the heave."""

    def __init__(self, kind="vi_excite", speed=0.5, room=(10.0, 6.0, 4.0),
                 amplitude=HEAVE_AMPLITUDE, omega=HEAVE_OMEGA):
        super().__init__(kind=kind, speed=speed, room=room)
        self.amplitude = amplitude
        self.omega = omega

    def _heave(self, t, value):
        out = np.zeros(np.shape(t) + (3,))
        out[..., 2] = value
        return out

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return super().pos(t) + self._heave(t, self.amplitude * np.sin(self.omega * t))

    def vel(self, t):
        t = np.asarray(t, np.float64)
        return super().vel(t) + self._heave(
            t, self.amplitude * self.omega * np.cos(self.omega * t))

    def acc(self, t):
        t = np.asarray(t, np.float64)
        return super().acc(t) + self._heave(
            t, -self.amplitude * self.omega ** 2 * np.sin(self.omega * t))


def heave_sequence(amplitude=HEAVE_AMPLITUDE, omega=HEAVE_OMEGA, kind="vi_excite", **kw):
    """A SyntheticSequence (keyword arguments as its own) whose trajectory
    is `kind`'s plus the vertical heave."""
    seq = SyntheticSequence(kind=kind, **kw)
    seq.traj = HeaveTrajectory(kind=kind, speed=seq.traj.speed, room=seq.traj.room,
                               amplitude=amplitude, omega=omega)
    return seq
