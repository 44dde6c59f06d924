"""Native host runtime of the port: the C++ lidar CSV parser and its
ctypes loader (built at first use, never at import)."""
