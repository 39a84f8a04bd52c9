"""The reference's scenes, one module a scene name (a configuration's
`scene.name`): scenes/<name>.py defines build(b, **kw), which adds the
scene's primitives, materials, media and camera to the scene that
scene.build assembles, the keyword arguments being the rest of the
configuration's `scene` entry but its width and height."""
