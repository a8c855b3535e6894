"""Traffic loops, one a file, found by a traffic mix's ``kind``."""
