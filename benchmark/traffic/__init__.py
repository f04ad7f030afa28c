"""Traffic: the frozen scan generator and the one generator of pools."""
