"""The device's idle share of the traced stretch, in percent: the reader
of device_idle_share.decode, read in the foreign decode cell."""
from benchmark import spec

read = spec.load_module("layer_metrics", "device_idle_share.decode").read
