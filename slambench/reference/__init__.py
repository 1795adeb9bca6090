"""The benchmark's plain reference and the comparisons that decide `correct`."""
