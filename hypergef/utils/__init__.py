from hypergef.utils.timing import Timer, device_time_per_iter

__all__ = ["device_time_per_iter", "Timer"]
