"""Host-side concurrency of the port (port of tpuslam/parallel/)."""
