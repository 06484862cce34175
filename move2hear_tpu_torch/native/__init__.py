"""The native graph walker: host C++ (m2h_native.cc) bound with ctypes
(binding.py), built by the host compiler at first use."""
