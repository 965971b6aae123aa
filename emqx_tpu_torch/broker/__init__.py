"""Broker runtime: sessions, channels, dispatch, listener.

Import the submodules directly (`broker.broker`, `broker.channel`, ...):
this package imports nothing itself, so `router` can import
`broker.session` without a cycle."""
