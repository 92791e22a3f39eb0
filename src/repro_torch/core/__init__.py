"""The advisor: extraction, model, tuner, partition, plan, execution."""
