"""The yardstick's arithmetic: the card's peaks, the kernels' operations
and bytes from their shapes, and device time from a profiler trace."""
