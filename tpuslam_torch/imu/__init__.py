"""IMU preintegration and inertial initialization (port of tpuslam/imu)."""
