"""The benchmark's plain reference: problem builders and the float64
host checks.  It imports nothing of the measured program."""
