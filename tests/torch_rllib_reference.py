"""A helper of the port's RLlib parity tests (no test of its own): the
gradients a reference algorithm's jitted step computes."""

import jax


def reference_grads(jitted_step, *args):
    """The gradients the reference's step computes when called with
    ``args``: its function (``__wrapped__``) traced once more under
    ``jax.jit`` with ``jax.value_and_grad`` recording what it returns (the
    step calls it once), and those returned."""
    real = jax.value_and_grad

    def run(*call):
        found = []

        def spy(fn, *a, **kw):
            vg = real(fn, *a, **kw)

            def recorded(*call_args):
                out = vg(*call_args)
                found.append(out[1])
                return out

            return recorded

        jax.value_and_grad = spy
        try:
            jitted_step.__wrapped__(*call)
        finally:
            jax.value_and_grad = real
        assert len(found) == 1
        return found[0]

    return jax.jit(run)(*args)
