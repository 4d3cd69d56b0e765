from .render import (
    DIFFERENTIABLE_FIELDS,
    apply_material_params,
    finite_difference_grad,
    get_material_params,
    image_loss,
    image_loss_unbiased,
    inverse_render,
    loss_and_grad,
    material_params_from_numpy,
    render_image_diff,
)
