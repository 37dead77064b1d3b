"""The calls into the port: ``programs/<resizer>.py`` builds the device
function that a configuration names and says which route it took."""
