"""End-to-end examples of the port: render_sfmoma (the SFMoMA demo scene to
novel views, with self-checks) and multiview_demo (a 2-view stereo LIF:
view switching, the stereo blend, the render modes and an orbit). Run
each as a module, ``python3 -m lif_tpu_torch.examples.render_sfmoma --out
DIR``; both render on the card unless ``--device cpu`` is given."""
