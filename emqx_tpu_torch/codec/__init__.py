"""MQTT wire codec (3.1 / 3.1.1 / 5.0)."""
