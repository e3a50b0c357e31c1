"""Frame observations, the pair tracker and the sequence drivers."""
