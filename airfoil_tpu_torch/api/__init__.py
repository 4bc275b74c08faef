"""HTTP API of the port (wind-tunnel routes); see ``minihttp``."""
