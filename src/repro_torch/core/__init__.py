"""The census core of the port: host planning (numpy) and the device
half (torch).  The public API is re-exported by :mod:`repro_torch`."""
