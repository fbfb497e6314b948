"""The benchmark's arithmetic: statistics over a window's frames, the
card's published peaks, the raster work counted from a frame's inputs, and
the reduction of a profiler trace to device time, launches and gaps."""
