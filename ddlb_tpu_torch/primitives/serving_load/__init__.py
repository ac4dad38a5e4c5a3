"""serving_load: the serving engine measured under open-loop traffic."""
