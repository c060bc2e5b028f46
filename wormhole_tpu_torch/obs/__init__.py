"""Process-wide metrics (counters, gauges, histograms) of the port."""
