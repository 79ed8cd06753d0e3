"""Training and serving runtime: step factories and the SpotTrainer control loop."""
